// Int8 convolution for Hopper (sm_90a): int8 activations x int8 weights with
// exact int32 accumulation and the dequantizing epilogue fused.
//
// Replaces the XLA int8 convolution of radet_tpu/ops/quant.py::Int8Conv
// (:182-193, conv_general_dilated with preferred_element_type=int32) and its
// epilogue (:194-197): out = float(acc) * mult[o] (+ bias[o]), then the cast
// to the output type.  mult = s_x * s_w is computed by the caller in float32,
// so the kernel repeats the reference's compiled arithmetic exactly: the
// int32 sum converted with round-to-nearest, one float32 multiply
// (__fmul_rn), or with a bias one fused multiply-add (__fmaf_rn: XLA
// contracts the multiply and the add), then the rounding to bfloat16 (or
// none for float32).  out_kind 2 writes the raw int32 sum.
//
// Design: an implicit GEMM, M = N * Ho * Wo output pixels by Cout / groups
// channels per group, K = kh * kw * (Cin / groups), walked tap by tap in
// chunks of 32 input channels (chunks past Cin / groups are zero-filled).
// Layouts: x NHWC int8, w OHWI int8 (Cout, kh, kw, Cin / groups), out NHWC.
// A block of 128 threads computes a 128 x 64 tile of one group with
// mma.sync.m16n8k32 s8 tensor-core products (4 warps of 64 x 32), fed from a
// 3-stage cp.async ring in shared memory (rows padded to 48 bytes, so the
// fragments' 32-bit loads hit 32 different banks).  When Cin / groups is not
// a multiple of 16 (a ResNeXt stage with 4 or 8 channels per group) the
// tiles are filled by plain byte loads instead.
//
// What bounds it on the H100: the int8 tensor-core rate (1979 TOPS dense)
// for the 3x3 convs at 256 channels, the bytes (3.35 TB/s) for the 1x1
// convs at 64 channels.  This first version is simple rather than fast: no
// wgmma, no TMA, no persistent blocks (PERF.md records its share of the
// bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block (within one group)
constexpr int BK = 32;       // input channels per k step (one mma k32)
constexpr int LDS = BK + 16;  // bytes per shared-memory row
constexpr int STAGES = 3;
constexpr int THREADS = 128;

struct Params {
  const int8_t* x;     // (N, H, W, C)
  const int8_t* w;     // (Cout, kh, kw, cin_g)
  const float* mult;   // (Cout)
  const float* bias;   // (Cout) or nullptr
  void* out;           // (N, Ho, Wo, Cout)
  int h, w_in, c, cout, kh, kw, sh, sw, ph, pw, ho, wo, cin_g, cout_g, cchunks, out_kind;
  long long m;         // N * Ho * Wo
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fill one stage: the A tile (BM pixels x 32 channels of tap `tap`, chunk
// `c0`) and the B tile (BN output channels x the same 32 weights).  Thread
// t owns A row t and half (t & 1) of B row t / 2.
template <bool VEC>
__device__ __forceinline__ void load_stage(const Params& p, int8_t* as, int8_t* bs, int kt, int tid,
                                           bool a_ok, long long a_pix, int hi0, int wi0, int cbase,
                                           int o_first) {
  const int tap = kt / p.cchunks;
  const int c0 = (kt - tap * p.cchunks) * BK;
  const int r = tap / p.kw, s = tap - r * p.kw;
  const int hi = hi0 + r, wi = wi0 + s;
  const bool inb = a_ok && hi >= 0 && hi < p.h && wi >= 0 && wi < p.w_in;
  // a_pix is the image index times H * W; the pixel is (hi, wi) of it
  const int8_t* arow = p.x + ((a_pix + (long long)hi * p.w_in + wi) * p.c + cbase);
  int8_t* adst = as + tid * LDS;
  const int brow = tid >> 1, bhalf = tid & 1;
  const int ob = o_first + brow;  // channel within the group
  const bool bok = ob < p.cout_g;
  const int8_t* bsrc = p.w + ((((long long)(cbase / p.cin_g * p.cout_g + ob) * p.kh + r) * p.kw + s) * p.cin_g);
  int8_t* bdst = bs + brow * LDS + 16 * bhalf;
  if (VEC) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = inb && c0 + 16 * j < p.cin_g;
      cp_async16(adst + 16 * j, ok ? (const void*)(arow + c0 + 16 * j) : (const void*)p.x, ok ? 16 : 0);
    }
    const bool ok = bok && c0 + 16 * bhalf < p.cin_g;
    cp_async16(bdst, ok ? (const void*)(bsrc + c0 + 16 * bhalf) : (const void*)p.w, ok ? 16 : 0);
  } else {
    uint32_t* a32 = reinterpret_cast<uint32_t*>(adst);
#pragma unroll
    for (int q = 0; q < BK / 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + q * 4 + e;
        const uint32_t byte = (inb && c < p.cin_g) ? (uint8_t)arow[c] : 0u;
        v |= byte << (8 * e);
      }
      a32[q] = v;
    }
    uint32_t* b32 = reinterpret_cast<uint32_t*>(bdst);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 16 * bhalf + q * 4 + e;
        const uint32_t byte = (bok && c < p.cin_g) ? (uint8_t)bsrc[c] : 0u;
        v |= byte << (8 * e);
      }
      b32[q] = v;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(Params p) {
  __shared__ __align__(16) int8_t a_s[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t b_s[STAGES][BN * LDS];

  const int tid = threadIdx.x;
  const int group = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o_first = blockIdx.y * BN;
  const int cbase = group * p.cin_g;

  // this thread's A row: output pixel m0 + tid
  const long long m = m0 + tid;
  const bool a_ok = m < p.m;
  long long a_pix = 0;
  int hi0 = 0, wi0 = 0;
  if (a_ok) {
    const long long hw = (long long)p.ho * p.wo;
    const long long n = m / hw;
    const int rem = (int)(m - n * hw);
    const int oh = rem / p.wo, ow = rem - (rem / p.wo) * p.wo;
    a_pix = n * p.h * p.w_in;
    hi0 = oh * p.sh - p.ph;
    wi0 = ow * p.sw - p.pw;
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int kt_total = p.kh * p.kw * p.cchunks;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < kt_total) load_stage<VEC>(p, a_s[st], b_s[st], st, tid, a_ok, a_pix, hi0, wi0, cbase, o_first);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_total; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < kt_total) {
      const int ns = nk % STAGES;
      load_stage<VEC>(p, a_s[ns], b_s[ns], nk, tid, a_ok, a_pix, hi0, wi0, cbase, o_first);
    }
    cp_async_commit();
    const int8_t* as = a_s[kt % STAGES];
    const int8_t* bs = b_s[kt % STAGES];
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wm * 64 + i * 16 + gr;
      af[i][0] = *reinterpret_cast<const uint32_t*>(as + row * LDS + tq * 4);
      af[i][1] = *reinterpret_cast<const uint32_t*>(as + (row + 8) * LDS + tq * 4);
      af[i][2] = *reinterpret_cast<const uint32_t*>(as + row * LDS + 16 + tq * 4);
      af[i][3] = *reinterpret_cast<const uint32_t*>(as + (row + 8) * LDS + 16 + tq * 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn * 32 + j * 8 + gr;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(bs + col * LDS + tq * 4);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(bs + col * LDS + 16 + tq * 4);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at (row gr, cols 2 tq, 2 tq + 1), c2, c3 at row gr + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = m0 + wm * 64 + i * 16 + gr + (e >> 1) * 8;
        const int oc = o_first + wn * 32 + j * 8 + tq * 2 + (e & 1);
        if (row >= p.m || oc >= p.cout_g) continue;
        const int o = group * p.cout_g + oc;
        const long long idx = row * p.cout + o;
        const int v = acc[i][j][e];
        if (p.out_kind == 2) {
          static_cast<int*>(p.out)[idx] = v;
          continue;
        }
        const float acc_f = __int2float_rn(v);
        const float y = p.bias != nullptr ? __fmaf_rn(acc_f, p.mult[o], p.bias[o]) : __fmul_rn(acc_f, p.mult[o]);
        if (p.out_kind == 0) {
          static_cast<float*>(p.out)[idx] = y;
        } else {
          static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x (n, h, w, c) int8, w (cout, kh, kw, c / groups) int8, mult (cout) float32,
// bias (cout) float32 or null, out (n, ho, wo, cout): float32 (out_kind 0),
// bfloat16 (1) or the int32 sums (2).  vec: c / groups % 16 == 0 and x, w
// 16-byte aligned.  Launches on `stream`; returns the launch's cudaError_t.
int radet_int8_conv(const void* x, const void* w, const void* mult, const void* bias, void* out, int n, int h,
                    int w_in, int c, int cout, int kh, int kw, int sh, int sw, int ph, int pw, int groups,
                    int out_kind, int vec, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.mult = static_cast<const float*>(mult);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.h = h;
  p.w_in = w_in;
  p.c = c;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.sh = sh;
  p.sw = sw;
  p.ph = ph;
  p.pw = pw;
  p.ho = (h + 2 * ph - kh) / sh + 1;
  p.wo = (w_in + 2 * pw - kw) / sw + 1;
  p.cin_g = c / groups;
  p.cout_g = cout / groups;
  p.cchunks = (p.cin_g + BK - 1) / BK;
  p.out_kind = out_kind;
  p.m = (long long)n * p.ho * p.wo;
  if (p.m <= 0 || cout <= 0) return 0;
  dim3 grid((unsigned)((p.m + BM - 1) / BM), (unsigned)((p.cout_g + BN - 1) / BN), (unsigned)groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    int8_conv_kernel<true><<<grid, THREADS, 0, s>>>(p);
  } else {
    int8_conv_kernel<false><<<grid, THREADS, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

const char* radet_int8_conv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
