// Batched vote-NMS for Hopper (sm_90a): three kernels on the caller's stream.
//
// Replaces radet_tpu/ops/pallas_nms.py::vote_nms_pallas (the TPU kernel
// _nms_kernel_tiled plus the wrapper's slot packing) and computes the same
// function as radet_tpu/ops/vote_nms.py::vote_nms_device_fast with
// presorted=True.  The plain PyTorch version is vote_nms_plain in
// radet_tpu_torch/ops/vote_nms.py.
//
// What bounds it: the same-label IoU > thr relation over the K (K - 1) / 2
// candidate pairs of each image, about 15 float32 operations a pair, is
// the only work that grows with K^2; the bytes are few (29 B in per
// candidate, 25 B out per slot).  So the bound is the IoU pass at the
// card's float32 rate: 3.75 us at B = 8, K = 2048 if every pair shares a
// label, less for real labels (chip_smoke.py::nms_bound counts the pairs
// of the data).  Around it sits a chain of dependent steps, the greedy
// keep, that no parallelism removes.  The
// Pallas kernel's MXU matvecs (pallas_nms.py _matvec/_matmul) exist only
// because a TPU reduces that way; this function has no matrix product for
// wgmma to serve, so the tensor cores stay idle.
//
// 1. overlap_kernel, a grid of (upper-triangle tile, image): each block
//    stages 256 column candidates in shared memory and each thread writes
//    one 32-bit word (32 columns) of one row of the bitmask "i and j valid,
//    same label, IoU > thr".  Only tiles whose column words reach the row's
//    own word run, so B K^2 / 2 pair tests spread over every SM.  A label
//    mismatch or an invalid box skips the test, and a zero intersection
//    skips the division (the IoU is exactly 0 then).  The arithmetic is
//    round-to-nearest intrinsics and IEEE division, never contracted into
//    FMAs, so the relation equals the float64 reference's on our inputs.
//    The words go to a global scratch of B K^2 / 8 bytes (4 MiB at B = 8,
//    K = 2048, inside the 50 MB L2; 64 MiB at B = 128, which is not); the
//    diagonal word of a row holds both triangles, the words left of it are
//    never written or read.
// 2. sweep_kernel, one block per image: the exact greedy keep one 32-box
//    word at a time.  For word w every warp takes the candidates
//    valid & ~removed and resolves them against the word's 32 diagonal
//    rows in registers (a fixed point of ballots: a candidate stays unless
//    a kept lower lane overlaps it); then thread v ORs word v of every kept
//    row into removed[v] with all loads in flight, and the block
//    synchronises only after a word that kept a box.  Every row's diagonal
//    word is staged in shared memory first, so a word that keeps nothing
//    waits on no load.  K dependent steps become K / 32.  Then: global mode keeps the first kept box of each
//    label; ranks by a block scan; seeds from the columns of the final-kept
//    rows (the lowest final-kept i < j whose row has bit j; a kept box
//    seeds itself, even at zero area); and a stable counting sort lists
//    each emitted seed's members by index.
// 3. vote_kernel, a grid of (8 seed ranks, image), one warp per seed of
//    rank < max_out: the block stages its seeds' members (boxes, and
//    weights computed once) in shared memory; three float32 passes over
//    the members only (weighted mean, centered variance
//    sum w (x - mean)^2, then the weighted mean of the 1-sigma inliers,
//    falling back to the mean), summed in a fixed order inside one warp: no
//    float atomics, so every run gives the same output.  The kernel fills
//    every slot, the empty ones with zeros.
//
// The 1-sigma bounds use the same intrinsics; the sums run in another order
// than the plain version's, so voted coordinates may differ on a small tail
// of 1-sigma boundary flips.
//
// The no-vote mode (do_vote = 0, with global_mode = 0) is plain class-aware
// greedy NMS, radet_tpu/ops/vote_nms.py::batched_nms_device on candidates
// sorted by score (ties in index order; plain version batched_nms_plain):
// the same overlap pass and greedy keep, then the sweep lists each kept box
// as its own only member and vote_kernel copies the kept boxes, their
// scores and labels into the slots, with no seeds and no vote.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;  // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8192;
constexpr int kMaxWords = kMaxK / 32;
constexpr int kTileWords = 8;  // overlap tile: 32 rows x 8 column words
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxWords <= kThreads, "the sweep gives each thread one word of the removed mask");
static_assert(kTileWords == kWarps, "one warp per column word of a tile");

// One image's part of the scratch: the bitmask (K rows of W words), then
// n_out, the member offsets by rank (K + 1) and the members (K); rounded up
// to 256 bytes.
__host__ __device__ inline size_t image_bytes(int K) {
  const size_t W = (K + 31) / 32;
  const size_t bytes = (size_t)K * W * sizeof(unsigned) + (2 * (size_t)K + 2) * sizeof(int);
  return (bytes + 255) & ~(size_t)255;
}

__device__ __forceinline__ unsigned* bitmask(unsigned char* scratch, size_t img, int K) {
  return reinterpret_cast<unsigned*>(scratch + img * image_bytes(K));
}

__device__ __forceinline__ int* meta(unsigned char* scratch, size_t img, int K) {
  const int W = (K + 31) >> 5;
  return reinterpret_cast<int*>(bitmask(scratch, img, K) + (size_t)K * W);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ float intersection(float4 a, float4 b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  return __fmul_rn(w, h);
}

// IoU as the reference computes it: inter / max(area_a + area_b - inter, 1e-12).
__device__ __forceinline__ float iou_of(float inter, float area_a, float area_b) {
  return __fdiv_rn(inter, fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f));
}

__device__ __forceinline__ float pair_iou(float4 a, float area_a, float4 b, float area_b) {
  return iou_of(intersection(a, b), area_a, area_b);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float coord(float4 b, int c) {
  return c == 0 ? b.x : c == 1 ? b.y : c == 2 ? b.z : b.w;
}

// Row words 8g .. 8g + 7 take the column tiles g .. NC - 1: the tiles that
// reach each row's diagonal word.  Sets (row word, column tile) of tile t,
// or, for t < 0, returns the number of tiles.
__host__ __device__ inline int tile_of(int W, int t, int* rw, int* ct) {
  const int NC = (W + kTileWords - 1) / kTileWords;
  int total = 0;
  for (int g = 0; g < NC; ++g) {
    const int rows = W - g * kTileWords < kTileWords ? W - g * kTileWords : kTileWords;
    const int n = rows * (NC - g);
    if (t >= 0 && t < n) {
      *rw = g * kTileWords + t / (NC - g);
      *ct = g + t % (NC - g);
      return 0;
    }
    t -= n;
    total += n;
  }
  return total;
}

// In-place exclusive scan of a[0, n) by the whole block; returns the total.
// tmp holds kWarps + 1 ints.
__device__ int block_exclusive_scan(int* a, int n, int* tmp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += a[k];
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < kWarps ? tmp[lane] : 0;
    int xi = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, xi, o);
      if (lane >= o) xi += v;
    }
    if (lane < kWarps) tmp[lane] = xi - x;
    if (lane == kWarps - 1) tmp[kWarps] = xi;
  }
  __syncthreads();
  int run = tmp[warp] + incl - sum;
  for (int k = lo; k < hi; ++k) {
    const int v = a[k];
    a[k] = run;
    run += v;
  }
  const int total = tmp[kWarps];
  __syncthreads();  // tmp is free for the next call
  return total;
}

// 1. the overlap bitmask, upper-triangle tiles of 32 rows x 256 columns
__global__ void __launch_bounds__(kThreads)
overlap_kernel(const float4* __restrict__ boxes, const int* __restrict__ labels,
               const bool* __restrict__ valid, unsigned char* __restrict__ scratch, int K,
               float iou_thr) {
  __shared__ float4 s_box[kThreads];
  __shared__ float s_area[kThreads];
  __shared__ int s_label[kThreads];
  __shared__ unsigned s_valid[kWarps];
  __shared__ unsigned s_out[32][kTileWords + 1];
  const int W = (K + 31) >> 5;
  int rw = 0, ct = 0;
  tile_of(W, blockIdx.x, &rw, &ct);
  const size_t img = blockIdx.y, base = img * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int j = ct * kTileWords * 32 + tid;  // this thread's column to stage
  if (j < K) {
    const float4 b = boxes[base + j];
    s_box[tid] = b;
    s_area[tid] = box_area(b);
    s_label[tid] = labels[base + j];
  }
  const unsigned vm = __ballot_sync(kFull, j < K && valid[base + j]);
  if (lane == 0) s_valid[warp] = vm;
  __syncthreads();

  const int i = rw * 32 + lane;          // this thread's row
  const int wc = ct * kTileWords + warp;  // and column word
  unsigned bits = 0u;
  if (wc >= rw && wc < W && i < K && valid[base + i]) {
    const float4 bi = boxes[base + i];
    const float ai = box_area(bi);
    const int li = labels[base + i];
    for (unsigned m = s_valid[warp]; m; m &= m - 1u) {
      const int bb = __ffs(m) - 1, c = warp * 32 + bb;
      if (s_label[c] != li) continue;
      const float inter = intersection(bi, s_box[c]);
      // IoU = 0 / union = 0 exactly when nothing intersects: no division
      if (inter == 0.f ? 0.f > iou_thr : iou_of(inter, ai, s_area[c]) > iou_thr) bits |= 1u << bb;
    }
  }
  s_out[lane][warp] = bits;
  __syncthreads();

  // 8 threads write one row's 8 words: 32 contiguous bytes
  const int r = tid >> 3, k = tid & 7;
  const int row = rw * 32 + r, word = ct * kTileWords + k;
  if (row < K && word >= rw && word < W)
    bitmask(scratch, img, K)[(size_t)row * W + word] = s_out[r][k];
}

// 2. greedy keep, global dedup, ranks, seeds and members; one block per image
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const int* __restrict__ labels, const bool* __restrict__ valid,
             unsigned char* __restrict__ scratch, int K, int max_out, int global_mode, int do_vote) {
  __shared__ unsigned s_valid[kMaxWords], s_removed[kMaxWords], s_keep[kMaxWords],
      s_final[kMaxWords];
  __shared__ int s_rank0[kMaxWords], s_scan[kWarps + 1];
  extern __shared__ int s_dyn[];
  unsigned* s_diag = reinterpret_cast<unsigned*>(s_dyn);  // each row's diagonal word
  int* s_order = s_dyn + K;     // final-kept boxes by rank
  int* s_srank = s_order + K;   // each box's seed rank if < max_out, else -1
  int* s_count = s_srank + K;   // members per rank, then their offsets

  const int W = (K + 31) >> 5;
  const size_t img = blockIdx.x, base = img * K;
  const unsigned* __restrict__ ovl = bitmask(scratch, img, K);
  int* out = meta(scratch, img, K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;

  for (int w = warp; w < W; w += kWarps) {
    const int i = (w << 5) + lane;
    const unsigned m = __ballot_sync(kFull, i < K && valid[base + i]);
    if (lane == 0) s_valid[w] = m;
  }
  if (tid < W) s_removed[tid] = 0u;
  for (int i = tid; i < K; i += kThreads) s_diag[i] = ovl[(size_t)i * W + (i >> 5)];
  __syncthreads();

  // greedy keep, one word per step; every warp resolves the word itself, so
  // the block meets only after a word that kept a box
  for (int w = 0; w < W; ++w) {
    const int row = (w << 5) + lane;
    const unsigned diag = row < K ? s_diag[row] : 0u;  // lane l: word w of row 32 w + l
    const unsigned cand = s_valid[w] & ~s_removed[w];
    unsigned keep = cand;
    if (cand) {
      // fixed point of "a candidate stays unless a kept lower lane overlaps
      // it": lane l settles once lanes < l have, so at most 33 rounds
      const bool mine = (cand >> lane) & 1u;
      const unsigned lower = diag & below;
      for (;;) {
        const unsigned next = __ballot_sync(kFull, mine && !(lower & keep));
        if (next == keep) break;
        keep = next;
      }
    }
    if (tid == 0) s_keep[w] = keep;
    if (!keep) continue;
    if (tid > w && tid < W) {
      const unsigned* col = ovl + tid;
      unsigned acc = 0u, m = keep;
      while (m) {
        unsigned x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          x[u] = 0u;
          if (m) {
            x[u] = col[(size_t)((w << 5) + __ffs(m) - 1) * W];
            m &= m - 1u;
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc |= x[u];
      }
      s_removed[tid] |= acc;
    }
    __syncthreads();
  }
  __syncthreads();

  // global mode: only the first kept box of each label (judged on the
  // greedy keep) emits
  for (int w = warp; w < W; w += kWarps) {
    const int i = (w << 5) + lane;
    bool f = (s_keep[w] >> lane) & 1u;
    if (f && global_mode) {
      const int li = labels[base + i];
      for (int v = 0; v <= w && f; ++v) {
        unsigned m = v == w ? s_keep[v] & below : s_keep[v];
        for (; m; m &= m - 1u) {
          if (labels[base + (v << 5) + __ffs(m) - 1] == li) {
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

  // ranks: final-kept boxes before each word, and the boxes by rank
  for (int w = tid; w < W; w += kThreads) s_rank0[w] = __popc(s_final[w]);
  __syncthreads();
  const int n_out = min(block_exclusive_scan(s_rank0, W, s_scan), max_out);
  for (int i = tid; i < K; i += kThreads) {
    const int w = i >> 5;
    const unsigned bit = 1u << (i & 31);
    if (s_final[w] & bit) s_order[s_rank0[w] + __popc(s_final[w] & (bit - 1u))] = i;
  }
  __syncthreads();

  int* offs = out + 1;
  int* members = out + K + 2;
  if (!do_vote) {  // each emitted box is its own only member
    for (int r = tid; r <= n_out; r += kThreads) {
      offs[r] = r;
      if (r < n_out) members[r] = s_order[r];
    }
    if (tid == 0) out[0] = n_out;
    return;
  }

  // seeds, one warp per word of boxes: the lowest emitted final-kept row
  // i < j with bit j (only the upper triangle is stored: column j of the
  // kept rows), a final-kept box itself
  for (int v = warp; v < W; v += kWarps) {
    const int j = (v << 5) + lane;
    const unsigned fin = s_final[v];
    int srank = -1;
    if ((fin >> lane) & 1u) srank = s_rank0[v] + __popc(fin & below);
    if (srank >= max_out) srank = -1;
    unsigned open = s_valid[v] & ~fin;  // boxes still without a seed
    const int n_rows = min(n_out, s_rank0[v] + __popc(fin));  // emitted rows above 32 (v + 1)
    for (int c = 0; c < n_rows && open; c += 32) {
      unsigned x = 0u;
      if (c + lane < n_rows) {
        const int i = s_order[c + lane];
        x = ovl[(size_t)i * W + v];
        if ((i >> 5) == v) x &= ~((2u << (i & 31)) - 1u);  // the diagonal word: j > i only
      }
      for (unsigned rows = __ballot_sync(kFull, (x & open) != 0u); rows; rows &= rows - 1u) {
        const int src = __ffs(rows) - 1;
        const unsigned hit = __shfl_sync(kFull, x, src) & open;
        if ((hit >> lane) & 1u) srank = c + src;
        open &= ~hit;
      }
    }
    if (j < K) s_srank[j] = srank;
  }

  // members by seed rank: counts, offsets, then a placement in index order
  for (int r = tid; r <= n_out; r += kThreads) s_count[r] = 0;
  __syncthreads();
  for (int j = tid; j < K; j += kThreads)
    if (s_srank[j] >= 0) atomicAdd(&s_count[s_srank[j]], 1);
  __syncthreads();
  const int n_members = block_exclusive_scan(s_count, n_out, s_scan);
  for (int r = tid; r < n_out; r += kThreads) offs[r] = s_count[r];
  if (tid == 0) {
    out[0] = n_out;
    offs[n_out] = n_members;
  }
  __syncthreads();  // s_count turns into the placement's cursors
  if (warp == 0) {
    for (int c = 0; c < K; c += 32) {
      const int j = c + lane;
      const int r = j < K ? s_srank[j] : -1;
      const unsigned same = __match_any_sync(kFull, r);
      const int pos = r >= 0 ? s_count[r] + __popc(same & below) : 0;
      __syncwarp();
      if (r >= 0) {
        members[pos] = j;
        if (!(same & below)) s_count[r] += __popc(same);
      }
      __syncwarp();
    }
  }
}

// 3. voting, one warp per emitted seed; a block takes kWarps seed ranks
__global__ void __launch_bounds__(kThreads)
vote_kernel(const float4* __restrict__ boxes, const float* __restrict__ cluster,
            const float* __restrict__ vote, const int* __restrict__ labels,
            unsigned char* __restrict__ scratch, int K, int max_out, int iou_enable,
            float sigma, int do_vote, float4* __restrict__ out_boxes, int* __restrict__ out_labels,
            float* __restrict__ out_scores, bool* __restrict__ out_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);  // this block's members
  float* s_w = reinterpret_cast<float*>(s_box + K);  // and their weights

  const size_t img = blockIdx.y, base = img * K, obase = img * max_out;
  const int* info = meta(scratch, img, K);
  const int n_out = info[0];
  const int* offs = info + 1;
  const int* members = info + K + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kWarps, r = r0 + warp;

  auto empty_slot = [&](int slot) {
    out_boxes[obase + slot] = make_float4(0.f, 0.f, 0.f, 0.f);
    out_labels[obase + slot] = -1;
    out_scores[obase + slot] = 0.f;
    out_valid[obase + slot] = false;
  };
  if (!do_vote) {  // the kept box itself, one thread per slot
    if (lane == 0 && r < n_out) {
      const int s = members[offs[r]];
      out_boxes[obase + r] = boxes[base + s];
      out_labels[obase + r] = labels[base + s];
      out_scores[obase + r] = cluster[base + s];
      out_valid[obase + r] = true;
    } else if (lane == 0 && r < max_out) {
      empty_slot(r);
    }
    return;
  }
  if (r0 >= n_out) {
    if (tid < kWarps && r0 + tid < max_out) empty_slot(r0 + tid);
    return;
  }
  const int m0 = offs[r0], m1 = offs[min(r0 + kWarps, n_out)];
  for (int m = m0 + tid; m < m1; m += kThreads) {
    const int j = members[m];
    s_box[m - m0] = boxes[base + j];
    s_w[m - m0] = vote[base + j];
  }
  __syncthreads();
  if (r >= n_out) {
    if (lane == 0 && r < max_out) empty_slot(r);
    return;
  }

  // this seed's members are [a, e); the seed is the first (lowest index)
  const int a = offs[r] - m0, e = offs[r + 1] - m0;
  const int s = members[offs[r]];
  const float4 bs = s_box[a];
  if (iou_enable) {
    const float as = box_area(bs);
    for (int m = a + lane; m < e; m += 32) {
      const float d = 1.f - pair_iou(bs, as, s_box[m], box_area(s_box[m]));
      s_w[m] = s_w[m] * expf(-(d * d) / sigma);
    }
  }
  float ws = 0.f, m1s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int m = a + lane; m < e; m += 32) {
    const float wj = s_w[m];
    ws += wj;
    for (int c = 0; c < 4; ++c) m1s[c] += wj * coord(s_box[m], c);
  }
  const float wsum = fmaxf(warp_sum(ws), 1e-12f);
  float mean[4], m2[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < 4; ++c) mean[c] = __fdiv_rn(warp_sum(m1s[c]), wsum);
  for (int m = a + lane; m < e; m += 32) {
    const float wj = s_w[m];
    for (int c = 0; c < 4; ++c) {
      const float d = __fsub_rn(coord(s_box[m], c), mean[c]);
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
  for (int m = a + lane; m < e; m += 32) {
    const float wj = s_w[m];
    for (int c = 0; c < 4; ++c) {
      const float x = coord(s_box[m], c);
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
    out_labels[obase + r] = labels[base + s];
    out_scores[obase + r] = cluster[base + s];
    out_valid[obase + r] = true;
  }
}

size_t sweep_smem(int K) { return (4 * (size_t)K + 1) * sizeof(int); }
size_t vote_smem(int K) { return (size_t)K * (sizeof(float4) + sizeof(float)); }

// The two kernels whose shared memory grows with K may take it up to
// kMaxK; set once per device and process.
cudaError_t allow_max_smem() {
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t result[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    cudaError_t e = cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sweep_smem(kMaxK));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)vote_smem(kMaxK));
    result[dev] = e;
  });
  return result[dev];
}

}  // namespace

extern "C" {

// Bytes of global scratch a launch at (B, K) needs.
size_t radet_vote_nms_scratch_bytes(int B, int K) {
  if (B <= 0 || K <= 0 || K > kMaxK) return 0;
  return (size_t)B * image_bytes(K);
}

// Launches the three kernels on `stream`; returns the first launch error
// (cudaGetLastError(), 0 on success).  `scratch` holds
// radet_vote_nms_scratch_bytes(B, K) bytes, 256-byte aligned.  do_vote = 0
// is the no-vote mode (plain greedy NMS; global_mode must be 0).
int radet_vote_nms(const void* boxes, const void* cluster, const void* vote,
                   const void* labels, const void* valid, void* scratch, void* out_boxes,
                   void* out_labels, void* out_scores, void* out_valid, int B, int K,
                   int max_out, float iou_threshold, int iou_enable, float sigma,
                   int global_mode, int do_vote, void* stream) {
  if (B <= 0 || B > 65535 || K <= 0 || K > kMaxK || max_out < 0) return (int)cudaErrorInvalidValue;
  if (!do_vote && global_mode) return (int)cudaErrorInvalidValue;
  if (scratch == nullptr || reinterpret_cast<size_t>(scratch) % 256) return (int)cudaErrorInvalidValue;
  if (max_out == 0) return (int)cudaSuccess;  // no slot to fill
  cudaError_t err = allow_max_smem();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* scr = static_cast<unsigned char*>(scratch);
  const float4* bx = static_cast<const float4*>(boxes);
  const int* lb = static_cast<const int*>(labels);
  const int W = (K + 31) / 32;
  int rw, ct;
  overlap_kernel<<<dim3(tile_of(W, -1, &rw, &ct), B), kThreads, 0, st>>>(
      bx, lb, static_cast<const bool*>(valid), scr, K, iou_threshold);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sweep_kernel<<<B, kThreads, sweep_smem(K), st>>>(lb, static_cast<const bool*>(valid), scr, K,
                                                   max_out, global_mode, do_vote);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  vote_kernel<<<dim3((max_out + kWarps - 1) / kWarps, B), kThreads, do_vote ? vote_smem(K) : 0, st>>>(
      bx, static_cast<const float*>(cluster), static_cast<const float*>(vote), lb, scr, K,
      max_out, iou_enable, sigma, do_vote, static_cast<float4*>(out_boxes),
      static_cast<int*>(out_labels), static_cast<float*>(out_scores), static_cast<bool*>(out_valid));
  return (int)cudaGetLastError();
}

const char* radet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
