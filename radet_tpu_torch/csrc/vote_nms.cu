// Batched vote-NMS for Hopper (sm_90a): one thread block per image.
//
// Replaces radet_tpu/ops/pallas_nms.py::vote_nms_pallas (the TPU kernel
// _nms_kernel_tiled plus the wrapper's slot packing) and computes the same
// function as radet_tpu/ops/vote_nms.py::vote_nms_device_fast with
// presorted=True.  The plain PyTorch version is vote_nms_plain in
// radet_tpu_torch/ops/vote_nms.py.
//
// What bounds it: each image is a latency-bound pass over K^2 candidate
// pairs (about 0.26 M pairs at K = 512, 4.2 M at the strict eval's
// K = 2048) plus a sequential greedy sweep; the bytes are trivial (K * 36
// bytes in, max_out * 25 bytes out per image).  What the design does about
// that: one launch covers the whole batch, nothing synchronises with the
// host, and every per-image quantity stays on chip where it fits.
//
// Two instantiations of one kernel, chosen by K:
//   kSlots = 1, K <= 1024: the per-candidate arrays (boxes, areas, labels,
//     vote scores, seeds, order) and the K x K same-label IoU > thr bitmask
//     live in shared memory (164 KB at K = 1024);
//   kSlots = 8, 1024 < K <= 8192: the bitmask alone is K * ceil(K/32) words
//     (512 KB at K = 2048) and at K = 8192 even the candidate arrays (288 KB)
//     exceed the 227 KB a block can have, so both live in a global scratch
//     that the wrapper allocates (radet_vote_nms_scratch_bytes: 584 KB per
//     image at K = 2048, which stays in the 50 MB L2 at eval batch sizes).
// The per-word masks (valid, keep, final keep, rank offsets) stay in shared
// memory in both.
//
// Phases, each ended by a block barrier:
//   0. load the image's candidates;
//   1. overlap bitmask: bit j of row i is set when i and j are both valid,
//      share a label and have IoU > thr (symmetric);
//   2. exact greedy keep: one warp sweeps the rows in index order, each lane
//      holding kSlots 32-bit words of the "removed" mask (word l + 32 s in
//      slot s of lane l);
//   3. global mode: drop a kept box whose label an earlier kept box has;
//   4. seeds: the first set bit of overlap[j] & keep at index < j, or j
//      itself when j is kept (forced self-membership, even at zero area);
//      ranks of the kept seeds by a warp scan over the keep words' popcounts;
//   5. voting, one warp per kept seed of rank < max_out: float32 passes over
//      its members (weighted mean, weighted centered variance, then the
//      weighted mean of the 1-sigma inliers), written into the seed's slot.
//
// Arithmetic that decides set membership (IoU > thr, the 1-sigma inlier
// bounds) uses round-to-nearest intrinsics and IEEE division, never
// contracted into FMAs, so the keep set matches the float32 reference
// exactly.  The variance is centered (sum of w * (x - mean)^2), as in the
// plain version: E[x^2] - mean^2 at 300-px coordinates keeps ~3 digits and
// flips ~1% of the 1-sigma tests between two float32 implementations.  The
// sums still run in another order than the plain version's, so voted
// coordinates may differ on a small tail of 1-sigma boundary flips.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallK = 1024;  // largest K whose arrays fit in shared memory
constexpr int kMaxK = 8192;
constexpr int kBigSlots = kMaxK / kSmallK;
constexpr unsigned kFull = 0xffffffffu;

// Bytes of one image's candidate arrays and bitmask rows (the layout the
// kernel carves), rounded up to 256 so every image's part of the scratch
// stays aligned.
__host__ __device__ inline size_t image_bytes(int K) {
  const size_t W = (K + 31) / 32;
  const size_t bytes = (size_t)K * (sizeof(float4) + 5 * sizeof(int)) + (size_t)K * W * sizeof(unsigned);
  return (bytes + 255) & ~(size_t)255;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// IoU as the reference computes it: inter / max(area_a + area_b - inter, 1e-12).
__device__ __forceinline__ float pair_iou(float4 a, float area_a, float4 b, float area_b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
  return __fdiv_rn(inter, uni);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float coord(float4 b, int c) {
  return c == 0 ? b.x : c == 1 ? b.y : c == 2 ? b.z : b.w;
}

// kSlots words of the removed mask per lane: K <= 1024 * kSlots.  With
// kSlots == 1 every array is in shared memory; otherwise the candidate
// arrays and bitmask rows (the s_* pointers below s_rank0) are this image's
// part of `scratch`.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
vote_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ cluster,
                const float* __restrict__ vote, const int* __restrict__ labels,
                const bool* __restrict__ valid, unsigned char* __restrict__ scratch, int K,
                int max_out, float iou_thr, int iou_enable, float sigma, int global_mode,
                float4* __restrict__ out_boxes, int* __restrict__ out_labels,
                float* __restrict__ out_scores, bool* __restrict__ out_valid) {
  constexpr int kMaxWords = 32 * kSlots;
  const int W = (K + 31) >> 5;
  const size_t img = blockIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_valid = reinterpret_cast<unsigned*>(smem);
  unsigned* s_keep = s_valid + kMaxWords;   // greedy keep
  unsigned* s_final = s_keep + kMaxWords;   // keep after the global dedup
  unsigned* s_rank0 = s_final + kMaxWords;  // kept boxes before word w
  unsigned char* arrays;
  if constexpr (kSlots == 1) {
    arrays = reinterpret_cast<unsigned char*>(s_rank0 + kMaxWords);
  } else {
    arrays = scratch + img * image_bytes(K);
  }
  float4* s_box = reinterpret_cast<float4*>(arrays);
  float* s_area = reinterpret_cast<float*>(s_box + K);
  float* s_vote = s_area + K;
  int* s_label = reinterpret_cast<int*>(s_vote + K);
  int* s_seed = s_label + K;
  int* s_order = s_seed + K;                            // kept seeds by rank
  unsigned* s_ovl = reinterpret_cast<unsigned*>(s_order + K);  // K rows of W words

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t base = img * K;
  const size_t obase = img * max_out;

  // 0. load
  for (int i = tid; i < K; i += blockDim.x) {
    const float4 b = boxes[base + i];
    s_box[i] = b;
    s_area[i] = box_area(b);
    s_vote[i] = vote[base + i];
    s_label[i] = labels[base + i];
  }
  for (int w = warp; w < W; w += nwarps) {
    const int i = (w << 5) + lane;
    const unsigned m = __ballot_sync(kFull, i < K && valid[base + i]);
    if (lane == 0) s_valid[w] = m;
  }
  __syncthreads();

  // 1. overlap bitmask; i runs fastest so a warp reads one j at a time
  for (int t = tid; t < K * W; t += blockDim.x) {
    const int i = t % K, w = t / K;
    unsigned bits = 0;
    if ((s_valid[i >> 5] >> (i & 31)) & 1u) {
      const float4 bi = s_box[i];
      const float ai = s_area[i];
      const int li = s_label[i];
      const unsigned vw = s_valid[w];
      const int n = min(32, K - (w << 5));
      for (int bb = 0; bb < n; ++bb) {
        const int j = (w << 5) + bb;
        if (((vw >> bb) & 1u) && s_label[j] == li &&
            pair_iou(bi, ai, s_box[j], s_area[j]) > iou_thr)
          bits |= 1u << bb;
      }
    }
    s_ovl[i * W + w] = bits;
  }
  __syncthreads();

  // 2. exact greedy keep, sequential in index (= score) order
  if (warp == 0) {
    unsigned removed[kSlots], kept[kSlots];  // slot s of lane l holds word l + 32 s
#pragma unroll
    for (int s = 0; s < kSlots; ++s) removed[s] = kept[s] = 0u;
    for (int i = 0; i < K; ++i) {
      const int w = i >> 5, slot = w >> 5;
      const unsigned bit = 1u << (i & 31);
      unsigned mine = removed[0];
#pragma unroll
      for (int s = 1; s < kSlots; ++s)
        if (s == slot) mine = removed[s];
      const unsigned rem_w = __shfl_sync(kFull, mine, w & 31);
      if ((s_valid[w] & bit) && !(rem_w & bit)) {
        const unsigned* row = s_ovl + (size_t)i * W;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int v = lane + 32 * s;
          if (v < W) removed[s] |= row[v];
          if (v == w) kept[s] |= bit;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int v = lane + 32 * s;
      if (v < W) s_keep[v] = kept[s];
    }
  }
  __syncthreads();

  // 3. global mode: the first kept box of each label emits
  for (int w = warp; w < W; w += nwarps) {
    const int i = (w << 5) + lane;
    bool f = i < K && ((s_keep[w] >> lane) & 1u);
    if (f && global_mode) {
      const int li = s_label[i];
      for (int v = 0; v <= w && f; ++v) {
        unsigned m = s_keep[v];
        if (v == w) m &= (1u << lane) - 1u;
        while (m) {
          const int j = (v << 5) + __ffs(m) - 1;
          m &= m - 1u;
          if (s_label[j] == li) {
            f = false;
            break;
          }
        }
      }
    }
    const unsigned m = __ballot_sync(kFull, f);
    if (lane == 0) s_final[w] = m;
  }
  __syncthreads();

  // 4. seeds, and each keep word's rank offset
  if (warp == 0) {
    // lane l scans words l * kSlots .. l * kSlots + kSlots - 1
    unsigned c[kSlots], total = 0u;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int v = lane * kSlots + s;
      c[s] = v < W ? __popc(s_final[v]) : 0u;
      total += c[s];
    }
    unsigned incl = total;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += n;
    }
    unsigned run = incl - total;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int v = lane * kSlots + s;
      if (v < W) s_rank0[v] = run;
      run += c[s];
    }
  }
  for (int j = tid; j < K; j += blockDim.x) {
    const int wj = j >> 5;
    const unsigned bj = 1u << (j & 31);
    int seed = K;
    if (s_final[wj] & bj) {
      seed = j;
    } else {
      const unsigned* row = s_ovl + j * W;
      for (int v = 0; v <= wj; ++v) {
        unsigned m = row[v] & s_final[v];
        if (v == wj) m &= bj - 1u;
        if (m) {
          seed = (v << 5) + __ffs(m) - 1;
          break;
        }
      }
    }
    s_seed[j] = seed;
  }
  __syncthreads();

  for (int i = tid; i < K; i += blockDim.x) {
    const int w = i >> 5;
    const unsigned bit = 1u << (i & 31);
    if (s_final[w] & bit) s_order[s_rank0[w] + __popc(s_final[w] & (bit - 1u))] = i;
  }
  const int n_out = min((int)(s_rank0[W - 1] + __popc(s_final[W - 1])), max_out);
  for (int r = n_out + tid; r < max_out; r += blockDim.x) {
    out_boxes[obase + r] = make_float4(0.f, 0.f, 0.f, 0.f);
    out_labels[obase + r] = -1;
    out_scores[obase + r] = 0.f;
    out_valid[obase + r] = false;
  }
  __syncthreads();

  // 5. voting, one warp per emitted seed: mean, centered variance, inliers
  for (int r = warp; r < n_out; r += nwarps) {
    const int s = s_order[r];
    const float4 bs = s_box[s];
    const float as = s_area[s];
    auto weight = [&](int j) {
      float wj = s_vote[j];
      if (iou_enable) {
        const float d = 1.f - pair_iou(bs, as, s_box[j], s_area[j]);
        wj = wj * expf(-(d * d) / sigma);
      }
      return wj;
    };
    float ws = 0.f, m1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = s + lane; j < K; j += 32) {
      if (s_seed[j] != s) continue;
      const float wj = weight(j);
      ws += wj;
      for (int c = 0; c < 4; ++c) m1[c] += wj * coord(s_box[j], c);
    }
    const float wsum = fmaxf(warp_sum(ws), 1e-12f);
    float mean[4], m2[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < 4; ++c) mean[c] = __fdiv_rn(warp_sum(m1[c]), wsum);
    for (int j = s + lane; j < K; j += 32) {
      if (s_seed[j] != s) continue;
      const float wj = weight(j);
      for (int c = 0; c < 4; ++c) {
        const float d = __fsub_rn(coord(s_box[j], c), mean[c]);
        m2[c] += wj * (d * d);
      }
    }
    float lo[4], hi[4];
    for (int c = 0; c < 4; ++c) {
      const float sig = __fsqrt_rn(fmaxf(__fdiv_rn(warp_sum(m2[c]), wsum), 0.f));
      lo[c] = __fsub_rn(mean[c], sig);
      hi[c] = __fadd_rn(mean[c], sig);
    }
    float den[4] = {0.f, 0.f, 0.f, 0.f}, num[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = s + lane; j < K; j += 32) {
      if (s_seed[j] != s) continue;
      const float wj = weight(j);
      for (int c = 0; c < 4; ++c) {
        const float x = coord(s_box[j], c);
        if (x >= lo[c] && x <= hi[c]) {
          den[c] += wj;
          num[c] += wj * x;
        }
      }
    }
    float voted[4];
    for (int c = 0; c < 4; ++c) {
      const float d = warp_sum(den[c]);
      const float n = warp_sum(num[c]);
      voted[c] = d > 0.f ? __fdiv_rn(n, fmaxf(d, 1e-12f)) : mean[c];
    }
    if (lane == 0) {
      out_boxes[obase + r] = make_float4(voted[0], voted[1], voted[2], voted[3]);
      out_labels[obase + r] = s_label[s];
      out_scores[obase + r] = cluster[base + s];
      out_valid[obase + r] = true;
    }
  }
}

}  // namespace

extern "C" {

// Bytes of global scratch a launch at (B, K) needs: 0 for K <= 1024.
size_t radet_vote_nms_scratch_bytes(int B, int K) {
  if (B <= 0 || K <= kSmallK || K > kMaxK) return 0;
  return (size_t)B * image_bytes(K);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `scratch` holds radet_vote_nms_scratch_bytes(B, K) bytes, 256-byte aligned
// (unused for K <= 1024).
int radet_vote_nms(const void* boxes, const void* cluster, const void* vote,
                   const void* labels, const void* valid, void* scratch, void* out_boxes,
                   void* out_labels, void* out_scores, void* out_valid, int B, int K,
                   int max_out, float iou_threshold, int iou_enable, float sigma,
                   int global_mode, void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxK || max_out < 0) return (int)cudaErrorInvalidValue;
  if (K > kSmallK && (scratch == nullptr || reinterpret_cast<size_t>(scratch) % 256))
    return (int)cudaErrorInvalidValue;
  const bool small = K <= kSmallK;
  auto kernel = small ? vote_nms_kernel<1> : vote_nms_kernel<kBigSlots>;
  const size_t words = 4 * 32 * (small ? 1 : kBigSlots) * sizeof(unsigned);
  const size_t smem = words + (small ? image_bytes(K) : 0);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(cluster),
      static_cast<const float*>(vote), static_cast<const int*>(labels),
      static_cast<const bool*>(valid), static_cast<unsigned char*>(scratch), K, max_out,
      iou_threshold, iou_enable, sigma, global_mode, static_cast<float4*>(out_boxes),
      static_cast<int*>(out_labels), static_cast<float*>(out_scores),
      static_cast<bool*>(out_valid));
  return (int)cudaGetLastError();
}

const char* radet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
