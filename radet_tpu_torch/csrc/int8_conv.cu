// Int8 convolution for Hopper (sm_90a): int8 activations x int8 weights with
// exact int32 accumulation and the dequantizing epilogue fused.
//
// Replaces the XLA int8 convolution of radet_tpu/ops/quant.py::Int8Conv
// (:182-193, conv_general_dilated with preferred_element_type=int32) and its
// epilogue (:194-197): out = float(acc) * mult[o] (+ bias[o]), then the cast
// to the output type.  mult = s_x * s_w is computed by the caller in float32,
// so both kernels repeat the reference's compiled arithmetic exactly: the
// int32 sum converted with round-to-nearest, one float32 multiply
// (__fmul_rn), or with a bias one fused multiply-add (__fmaf_rn: XLA
// contracts the multiply and the add), then the rounding to bfloat16 (or
// none for float32).  out_kind 2 writes the raw int32 sum.  Integer sums are
// exact in any order, so both are bit-equal to ops/quant.py::int8_conv_plain.
// Layouts: x NHWC int8, w OHWI int8 (Cout, kh, kw, Cin / groups), out NHWC.
// Both are implicit GEMMs: M = N * Ho * Wo output pixels, N = Cout / groups
// channels, K = kh * kw * Cin / groups, walked tap by tap in channel chunks.
//
// Which kernel takes a call is a static rule on shape and alignment,
// ops/int8_conv_cuda.py::plan: the wgmma kernel when groups == 1, Cin % 16 ==
// 0, Cout % 8 == 0 (bf16 out; % 4 for 4-byte out) and x and w are 16-byte
// aligned (every int8 conv of configs/bop's int8 configs); the mma.sync
// kernel otherwise (grouped convs, ResNeXt's 4 or 8 channels a group).
//
// 1. int8_conv_wgmma_kernel<BN> (namespace wg).  A block of three
//    warpgroups computes 128 output pixels x BN (64, 128 or 256) channels
//    per tile: warpgroup 2 is the producer, one thread of it keeping a ring
//    of 1-8 stages full with TMA loads (an mbarrier pair per stage: "full"
//    completes with the bytes, "empty" with the 8 consumer warps'
//    arrivals); warpgroups 0 and 1 each run wgmma.mma_async m64nBNk32
//    .s32.s8.s8 on their 64 rows, both operands read from shared memory
//    K-major (NHWC channels and OHWI input channels are contiguous, which
//    8-bit wgmma requires), one group kept in flight while the previous
//    stage is released.  BN is 256 over a deep reduction (kh kw Cin >=
//    2048), 128 over a shallow one (a deeper ring: 6 stages against 4),
//    64 for Cout <= 64.  A stage holds BK = 128 bytes of K (128-byte
//    swizzle), 64 where Cin % 128 != 0 or BN = 64 (64-byte swizzle), else
//    32 (32-byte swizzle); channels past Cin are zero-filled.
//    The A tile is one 4-D TMA box of the NHWC input: bk channels x a
//    patch of pw x ph output pixels x pn images (pw * ph * pn = 128, powers
//    of two chosen by plan() to waste the fewest rows at each level's
//    width) at the origin shifted by the tap; the hardware's out-of-bounds
//    fill gives the zero padding, and a stride of 2 is the box's element
//    stride (elementStrides = 2 in W and H: the box spans 2 pw input
//    columns and delivers pw), chosen over TMA's im2col mode because the
//    tiled mode keeps one code path for every tap, stride and padding and
//    the same swizzled box layout as the 1x1 case.  A 1x1 stride-1 conv is
//    the same box over the input seen as one row of N * H * W pixels (a
//    plain 2-D GEMM, no rows wasted).  B is a 2-D box of the weights as a
//    (Cout, K) matrix.  Epilogue: each consumer converts its accumulators
//    with the arithmetic above, writes 128-byte-wide column blocks to
//    shared memory (128-byte swizzle: conflict-free 4- and 8-byte stores)
//    and one thread stores each block with a TMA store (whole rows, edges
//    clipped by the hardware), two buffers alternating.  Persistent: plan()
//    may launch min(tiles, SMs) blocks walking a static tile order (output
//    channels fastest, so neighbours share the A tile in L2), so that one
//    tile's epilogue overlaps the next tile's loads.  The host encodes the
//    three tensor maps per call (cuTensorMapEncodeTiled through the
//    runtime's driver entry point) and passes them as __grid_constant__
//    parameters.  A barrier wait that lasts ~10 s traps instead of hanging.
// 2. int8_conv_kernel<VEC> (the first, simpler kernel; the other shapes):
//    a block of 128 threads computes a 128 x 64 tile of one group with
//    mma.sync.m16n8k32 s8 products (4 warps of 64 x 32), fed from a 3-stage
//    cp.async ring (rows padded to 48 bytes, so the fragments' 32-bit loads
//    hit 32 different banks); when Cin / groups is not a multiple of 16 the
//    tiles are filled by plain byte loads instead.  Simple, not fast.
//
// What bounds them on the H100: the int8 tensor-core rate (1979 TOPS dense)
// for the 3x3 convs at 256 channels, the bytes (3.35 TB/s) for the 1x1
// convs and the 64-channel 3x3s.  PERF.md records each shape's time and
// share of its bound for both kernels.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <mutex>

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

// ---------------------------------------------------------------------------
// The wgmma + TMA kernel (groups == 1, Cin % 16 == 0, 16-byte aligned).

namespace wg {

constexpr int BM = 128;             // output pixels per tile: two consumer warpgroups of 64 rows
constexpr int THREADS = 384;        // warpgroups 0 and 1 consume, warpgroup 2 loads
constexpr int MAX_STAGES = 8;
constexpr int EPI_BYTES = 8192;     // one store buffer: 64 rows x 128 bytes
constexpr int SMEM_LIMIT = 232448;  // the opt-in maximum of one block on the H100
constexpr unsigned long long WATCHDOG_CYCLES = 20000000000ull;  // ~10 s: trap instead of hanging

// the launch's configuration, in the order of ops/int8_conv_cuda.py::WGMMA_CFG
enum Cfg {
  CFG_C_IN, CFG_A_W, CFG_A_H, CFG_A_N, CFG_O_W, CFG_O_H, CFG_COUT, CFG_KH, CFG_KW, CFG_SH, CFG_SW, CFG_PAD_H,
  CFG_PAD_W, CFG_PATCH_W, CFG_PATCH_H, CFG_PATCH_N, CFG_TILES_W, CFG_TILES_H, CFG_TILES_N, CFG_TILES_O, CFG_SPLIT,
  CFG_BK, CFG_BN, CFG_STAGES, CFG_OUT_KIND, CFG_GRID, CFG_SMEM, CFG_N
};

struct Params {
  const float* mult;
  const float* bias;  // or nullptr
  int cin, cout, kw, sh, sw, pad_h, pad_w;
  int pw, ph, pn, tw, th, to, total;
  int chunks, bk, kiters, stages, stage_bytes, b_offset, out_kind;
  int half_w, half_h, half_n;  // the second consumer's offset in the tile (pixels, rows, images)
  uint64_t desc_bits;          // swizzle mode and stride of the operand descriptors
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const unsigned long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WATCHDOG_CYCLES) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, "
      "%5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the shared-memory matrix descriptor of a K-major operand tile at `addr`
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint64_t bits) {
  return bits | (uint64_t)((addr >> 4) & 0x3FFF);
}

// D (64 x N, int32) += A (64 x 32 s8, K-major) * B (N x 32 s8, K-major);
// scale_d = 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The epilogue of one warpgroup's 64 x BN accumulators: dequantize, stage
// each 128-byte-wide column block in shared memory (128-byte swizzle, as
// the output map reads it) and store it with one TMA store; two buffers
// alternate, so one block's store overlaps the next one's conversion.
template <int BN, int ESIZE>
__device__ __forceinline__ void epilogue(const Params& p, const CUtensorMap* omap, const int* acc, uint8_t* epi,
                                         int& ebuf, bool lead, int wgi, int warp, int lane, int o0, int ow, int oh,
                                         int on) {
  constexpr int CW = 128 / ESIZE;  // output channels per store block
  const int quad = lane & 3;
#pragma unroll
  for (int q = 0; q < BN / CW; ++q) {
    if (o0 + q * CW >= p.cout) break;  // uniform: the block lies past the last channel
    uint8_t* sb = epi + (wgi * 2 + ebuf) * EPI_BYTES;
    if (lead) bulk_wait_read<1>();  // the store that last read this buffer is done with it
    named_sync(1 + wgi, 128);
#pragma unroll
    for (int jj = 0; jj < CW / 8; ++jj) {
      const int j = q * (CW / 8) + jj;
      const int col = o0 + q * CW + jj * 8 + quad * 2;
      float m0 = 0.f, m1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (p.out_kind != 2) {
        if (col < p.cout) m0 = __ldg(p.mult + col);
        if (col + 1 < p.cout) m1 = __ldg(p.mult + col + 1);
        if (p.bias != nullptr) {
          if (col < p.cout) b0 = __ldg(p.bias + col);
          if (col + 1 < p.cout) b1 = __ldg(p.bias + col + 1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + (lane >> 2) + 8 * h;
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        uint32_t w0 = (uint32_t)v0, w1 = (uint32_t)v1;
        if (p.out_kind != 2) {
          const float f0 = __int2float_rn(v0), f1 = __int2float_rn(v1);
          const float y0 = p.bias != nullptr ? __fmaf_rn(f0, m0, b0) : __fmul_rn(f0, m0);
          const float y1 = p.bias != nullptr ? __fmaf_rn(f1, m1, b1) : __fmul_rn(f1, m1);
          w0 = __float_as_uint(y0);
          w1 = __float_as_uint(y1);
          if (ESIZE == 2) {
            const __nv_bfloat16 h0 = __float2bfloat16_rn(y0), h1 = __float2bfloat16_rn(y1);
            w0 = (uint32_t)__bfloat16_as_ushort(h0) | ((uint32_t)__bfloat16_as_ushort(h1) << 16);
          }
        }
        // byte offset of the pair in the 128-byte row, then the 128-byte swizzle:
        // 16-byte chunk c of row r lies at chunk c ^ (r % 8)
        const int byte = (jj * 8 + quad * 2) * ESIZE;
        const uint32_t addr = smem_u32(sb + row * 128 + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15)));
        if (ESIZE == 2) {
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(w0) : "memory");
        } else {
          asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(w0), "r"(w1) : "memory");
        }
      }
    }
    fence_proxy_async();  // the generic-proxy writes, visible to the TMA store
    named_sync(1 + wgi, 128);
    if (lead) {
      tma_store_4d(omap, smem_u32(sb), o0 + q * CW, ow, oh, on);
      bulk_commit();
    }
    ebuf ^= 1;
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                           const __grid_constant__ CUtensorMap omap, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle's repeat
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* epi = smem + p.stages * p.stage_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(epi + 4 * EPI_BYTES);  // full[MAX_STAGES], empty[MAX_STAGES]
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + MAX_STAGES);

  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    // the producer: one thread keeps the ring full with TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.total; t += gridDim.x) {
        const int mt = t / p.to, ot = t - mt * p.to;
        const int wt = mt % p.tw, ht = (mt / p.tw) % p.th, nt = mt / (p.tw * p.th);
        const int x0 = wt * p.pw * p.sw - p.pad_w, y0 = ht * p.ph * p.sh - p.pad_h, n0 = nt * p.pn;
        const int o0 = ot * BN;
        for (int k = 0; k < p.kiters; ++k) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, p.stage_bytes);
          const int tap = k / p.chunks, c = k - tap * p.chunks;
          const int r = tap / p.kw, s = tap - r * p.kw;
          const uint32_t a = smem_u32(smem + stage * p.stage_bytes);
          tma_load_4d(a, &amap, full, c * p.bk, x0 + s, y0 + r, n0);
          tma_load_2d(a + p.b_offset, &bmap, full, tap * p.cin + c * p.bk, o0);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup wgi multiplies rows 64 wgi .. 64 wgi + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const bool lead = (threadIdx.x & 127) == 0;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int stage = 0, ebuf = 0;
    uint32_t phase = 0;
    const uint32_t a_row = wgi * 64 * p.bk;  // this warpgroup's 64 rows of the A tile
    for (int t = blockIdx.x; t < p.total; t += gridDim.x) {
      const int mt = t / p.to, ot = t - mt * p.to;
      const int wt = mt % p.tw, ht = (mt / p.tw) % p.th, nt = mt / (p.tw * p.th);
      int prev = 0;
      for (int k = 0; k < p.kiters; ++k) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a = smem_u32(smem + stage * p.stage_bytes);
        const uint64_t da = make_desc(a + a_row, p.desc_bits), db = make_desc(a + p.b_offset, p.desc_bits);
        fence_regs<BN / 2>(acc);
        wgmma_fence();
        for (int kk = 0; kk < p.bk / 32; ++kk) {
          // the next 32 bytes of K lie 32 bytes further along every row (2 units of 16)
          wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        fence_regs<BN / 2>(acc);
        if (k > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      const int ow = wt * p.pw + wgi * p.half_w, oh = ht * p.ph + wgi * p.half_h, on = nt * p.pn + wgi * p.half_n;
      if (p.out_kind == 1) {
        epilogue<BN, 2>(p, &omap, acc, epi, ebuf, lead, wgi, warp, lane, ot * BN, ow, oh, on);
      } else {
        epilogue<BN, 4>(p, &omap, acc, epi, ebuf, lead, wgi, warp, lane, ot * BN, ow, oh, on);
      }
    }
    if (lead) bulk_wait_all();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  std::call_once(once, [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  });
  return fn;
}

CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <int BN>
cudaError_t allow_smem() {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t result[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    result[dev] = cudaFuncSetAttribute(int8_conv_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_LIMIT);
  });
  return result[dev];
}

template <int BN>
int launch(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& o, const Params& p, int grid, int smem,
           cudaStream_t s) {
  cudaError_t err = allow_smem<BN>();
  if (err != cudaSuccess) return (int)err;
  int8_conv_wgmma_kernel<BN><<<grid, THREADS, smem, s>>>(a, b, o, p);
  return (int)cudaGetLastError();
}

constexpr int ENCODE_ERROR = 1000000;  // the first error code of a refused tensor map

int run(const void* x, const void* w, const void* mult, const void* bias, void* out, const int* cfg,
        cudaStream_t stream) {
  typedef cuuint64_t u64;
  typedef cuuint32_t u32;
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int c = cfg[CFG_C_IN], cout = cfg[CFG_COUT], kh = cfg[CFG_KH], kw = cfg[CFG_KW];
  const int sh = cfg[CFG_SH], sw = cfg[CFG_SW], a_w = cfg[CFG_A_W], a_h = cfg[CFG_A_H], a_n = cfg[CFG_A_N];
  const int o_w = cfg[CFG_O_W], o_h = cfg[CFG_O_H];
  const int pw = cfg[CFG_PATCH_W], ph = cfg[CFG_PATCH_H], pn = cfg[CFG_PATCH_N], split = cfg[CFG_SPLIT];
  const int bk = cfg[CFG_BK], bn = cfg[CFG_BN], stages = cfg[CFG_STAGES], out_kind = cfg[CFG_OUT_KIND];
  const int grid = cfg[CFG_GRID], smem = cfg[CFG_SMEM];
  const int es = out_kind == 1 ? 2 : 4;  // output element bytes
  const int stage_bytes = (BM + bn) * bk;
  if ((bn != 64 && bn != 128 && bn != 256) || (bk != 32 && bk != 64 && bk != 128) || stages < 1 ||
      stages > MAX_STAGES || out_kind < 0 || out_kind > 2 || pw * ph * pn != BM || split < 0 || split > 2 ||
      grid < 1 || smem < 1024 + stages * stage_bytes + 4 * EPI_BYTES + 16 * 8 || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;

  CUtensorMap amap, bmap, omap;
  // A: the NHWC input (one row of N * H * W pixels for a 1x1 stride-1 conv),
  // a box of bk channels x the patch at the conv's strides; out-of-bounds
  // elements (the padding, channels past c) arrive as zeros
  const u64 adims[4] = {(u64)c, (u64)a_w, (u64)a_h, (u64)a_n};
  const u64 astr[3] = {(u64)c, (u64)a_w * c, (u64)a_h * a_w * c};
  const u32 abox[4] = {(u32)bk, (u32)(pw * sw), (u32)(ph * sh), (u32)pn};
  const u32 aes[4] = {1, (u32)sw, (u32)sh, 1};
  CUresult r = encode(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), adims, astr, abox, aes,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + (int)r;
  // B: the OHWI weights as a (cout, kh * kw * c) matrix
  const u64 ktot = (u64)kh * kw * c;
  const u64 bdims[2] = {ktot, (u64)cout};
  const u64 bstr[1] = {ktot};
  const u32 bbox[2] = {(u32)bk, (u32)bn};
  const u32 bes[2] = {1, 1};
  r = encode(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), bdims, bstr, bbox, bes,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + 1000 + (int)r;
  // the output (NHWC, or the same rows), a box of 128 bytes of channels x one
  // consumer warpgroup's half of the patch; the store clips the edges
  const u64 odims[4] = {(u64)cout, (u64)o_w, (u64)o_h, (u64)a_n};
  const u64 ostr[3] = {(u64)cout * es, (u64)o_w * cout * es, (u64)o_h * o_w * cout * es};
  const u32 obox[4] = {(u32)(128 / es), (u32)(pw >> (split == 0)), (u32)(ph >> (split == 1)),
                       (u32)(pn >> (split == 2))};
  const u32 oes[4] = {1, 1, 1, 1};
  r = encode(&omap, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16 : CU_TENSOR_MAP_DATA_TYPE_INT32, 4, out, odims, ostr,
             obox, oes, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + 2000 + (int)r;

  Params p;
  p.mult = static_cast<const float*>(mult);
  p.bias = static_cast<const float*>(bias);
  p.cin = c;
  p.cout = cout;
  p.kw = kw;
  p.sh = sh;
  p.sw = sw;
  p.pad_h = cfg[CFG_PAD_H];
  p.pad_w = cfg[CFG_PAD_W];
  p.pw = pw;
  p.ph = ph;
  p.pn = pn;
  p.tw = cfg[CFG_TILES_W];
  p.th = cfg[CFG_TILES_H];
  p.to = cfg[CFG_TILES_O];
  p.total = p.tw * p.th * cfg[CFG_TILES_N] * p.to;
  p.bk = bk;
  p.chunks = (c + bk - 1) / bk;
  p.kiters = kh * kw * p.chunks;
  p.stages = stages;
  p.stage_bytes = stage_bytes;
  p.b_offset = BM * bk;
  p.out_kind = out_kind;
  p.half_w = split == 0 ? pw / 2 : 0;
  p.half_h = split == 1 ? ph / 2 : 0;
  p.half_n = split == 2 ? pn / 2 : 0;
  // operand descriptors: leading offset 1 (unused by a swizzled K-major
  // operand), 8 rows x bk bytes between 8-row groups, swizzle 128 / 64 / 32 B
  const uint64_t layout = bk == 128 ? 1 : bk == 64 ? 2 : 3;
  p.desc_bits = (1ull << 16) | ((uint64_t)((8 * bk) >> 4) << 32) | (layout << 62);
  switch (bn) {
    case 64:
      return launch<64>(amap, bmap, omap, p, grid, smem, stream);
    case 128:
      return launch<128>(amap, bmap, omap, p, grid, smem, stream);
    default:
      return launch<256>(amap, bmap, omap, p, grid, smem, stream);
  }
}

}  // namespace wg

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

// x (n, h, w, c) int8, w (cout, kh, kw, c) int8, mult (cout) float32, bias
// (cout) float32 or null, out (n, ho, wo, cout) of the out kind, all 16-byte
// aligned; cfg: the wg::CFG_N ints of ops/int8_conv_cuda.py::plan in the
// order of wg::Cfg.  Encodes the three tensor maps on the host and launches
// on `stream`; returns 0, a cudaError_t, or wg::ENCODE_ERROR + 1000 * map +
// the driver's CUresult when a tensor map is refused.
int radet_int8_conv_wgmma(const void* x, const void* w, const void* mult, const void* bias, void* out,
                          const int* cfg, void* stream) {
  return wg::run(x, w, mult, bias, out, cfg, static_cast<cudaStream_t>(stream));
}

const char* radet_int8_conv_error_string(int err) {
  static thread_local char buf[160];
  if (err >= wg::ENCODE_ERROR) {
    const char* maps[3] = {"input", "weight", "output"};
    const int m = (err - wg::ENCODE_ERROR) / 1000;
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled refused the %s map (CUresult %d)", maps[m < 3 ? m : 2],
             (err - wg::ENCODE_ERROR) % 1000);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
