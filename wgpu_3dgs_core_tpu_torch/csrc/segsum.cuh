// K5, the segment sums of the gid-sorted gradients, as one source
// templated on the levels of K10 (sm_90a).
//
// csrc/segreduce.cu launches launch_segment_sums<kS2Gather>: that is K5,
// its two kernels (the design is described there). K10
// (csrc/variants.cu) launches every level from this same source, so its
// full level is K5 compiled again, and each level below it is K5 with
// the ingredients after it taken out. Levels, cumulative:
//   kS0Prep     K5's first kernel alone: the slot-major staging copy
//               [9, f] -> [f, 9], the row_of map, the zeroed output;
//   kS1Scan     the segmented-scan kernel over a slot-major copy already
//               in key order (the caller permutes it): no gather, K5's
//               sums in K5's order;
//   kS2Gather   the read through the sort's permutation: K5;
//   kS2NoStage  kS2Gather reading straight from [9, f] through the
//               permutation, the prep writing only row_of and the zeros:
//               kS2Gather - kS2NoStage prices the staging copy.
// The read is an `if constexpr`, so kS2Gather compiles to the kernels K5
// was before the levels shared its source.
#pragma once

#include <climits>

#include "common.cuh"

namespace {
namespace segsum {

enum Level : int {
  kS0Prep = 0,
  kS1Scan = 1,
  kS2Gather = 2,
  kS2NoStage = 3,
};

constexpr int kThreads = 256;
constexpr int kRows = 9;
constexpr unsigned kFull = 0xffffffffu;
// K5: slots per thread in a tile, slots per tile, tiles per chunk (a
// block's own slots), warps per block. ops/segreduce.py's SEGSUM_CHUNK
// must equal kChunk.
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kChunkTiles = 2;
constexpr int kChunk = kTile * kChunkTiles;
constexpr int kWarps = kThreads / 32;

// K5's first kernel. Blocks [0, slot_blocks) copy kThreads slots each of
// grad [9, f] into grad_t [f, 9] through shared memory (both sides read
// and written contiguously); the blocks after take kThreads rows each of
// the gid column: row_of[g] = r for the first row r holding the live gid
// g, and zeros in column r of out. row_of is otherwise left as it was.
__global__ void __launch_bounds__(kThreads)
segment_sums_prep_kernel(const float* __restrict__ grad, int f,
                         int slot_blocks, const int* __restrict__ gid_col,
                         int n_rows, int n, float* __restrict__ grad_t,
                         int* __restrict__ row_of, float* __restrict__ out) {
  const int tid = threadIdx.x;
  if (blockIdx.x < slot_blocks) {
    __shared__ float tile[kRows][kThreads + 1];
    const int j0 = blockIdx.x * kThreads;
    const size_t fs = static_cast<size_t>(f);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      tile[r][tid] = j0 + tid < f ? __ldg(grad + r * fs + j0 + tid) : 0.0f;
    }
    __syncthreads();
    float* dst = grad_t + static_cast<size_t>(j0) * kRows;
    const int total = min(kThreads, f - j0) * kRows;
    for (int e = tid; e < total; e += kThreads) {
      dst[e] = tile[e % kRows][e / kRows];
    }
    return;
  }
  const int r = (blockIdx.x - slot_blocks) * kThreads + tid;
  if (r >= n_rows) return;
  const int g = __ldg(gid_col + r);
  if (g < n && (r == 0 || __ldg(gid_col + r - 1) != g)) row_of[g] = r;
  const size_t ns = static_cast<size_t>(n_rows);
#pragma unroll
  for (int k = 0; k < kRows; ++k) out[k * ns + r] = 0.0f;
}

// One element of the segmented sum: whether a run head lies in its span,
// and the 9 sums since the last head. `b.combine_after(a)` makes b the
// element of the span a then b (a's sums are added only if b has no head).
struct Seg {
  bool head;
  float v[kRows];

  __device__ __forceinline__ void combine_after(bool a_head,
                                                const float (&a_v)[kRows]) {
    if (!head) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = a_v[r] + v[r];
    }
    head = head || a_head;
  }
};

// Inclusive segmented scan of one element per lane across the warp.
__device__ __forceinline__ void warp_segmented_scan(Seg& s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool up_head = __shfl_up_sync(kFull, static_cast<int>(s.head), off);
    float up_v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      up_v[r] = __shfl_up_sync(kFull, s.v[r], off);
    }
    if (lane >= off) s.combine_after(up_head, up_v);
  }
}

// K5's second kernel, over the prep kernel's row_of map, out already
// zeroed. src is the gradients the level reads: the slot-major grad_t
// [f, 9] through the permutation (kS2Gather: K5), grad_t already in key
// order (kS1Scan), or grad [9, f] through the permutation (kS2NoStage).
template <int kLevel>
__global__ void __launch_bounds__(kThreads)
segment_sums_kernel(const int* __restrict__ keys,
                    const long long* __restrict__ perm,
                    const float* __restrict__ src, int f,
                    const int* __restrict__ gid_col,
                    const int* __restrict__ row_of, int n_rows, int n,
                    float* __restrict__ out) {
  __shared__ int s_first_head[kWarps];
  __shared__ int s_warp_head[kWarps];
  __shared__ float s_warp_v[kWarps][kRows];
  __shared__ int s_walk_on;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = blockIdx.x * kChunk;
  if (__ldg(keys + chunk) >= n) return;  // past the drawn prefix
  const size_t ns = static_cast<size_t>(n_rows);

  // The running element at the end of the tiles walked so far. In the
  // chunk's own tiles its head says whether a head was seen (slots before
  // the chunk's first head belong to an earlier block's run); past the
  // chunk it restarts false, and the walk owns slots until the next head.
  Seg carry;
  carry.head = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) carry.v[r] = 0.0f;

  for (int t = 0;; ++t) {
    const bool own_tile = t < kChunkTiles;
    if (t == kChunkTiles) carry.head = false;
    const int base = chunk + t * kTile;
    const int j0 = base + tid * kItems;

    // Keys of this thread's slots and of their neighbours; n marks a slot
    // past the drawn prefix (or past f).
    int key[kItems + 2];
#pragma unroll
    for (int i = 0; i < kItems + 2; ++i) {
      const int j = j0 - 1 + i;
      key[i] = (j < 0) ? -1 : (j < f ? __ldg(keys + j) : n);
    }
    bool valid[kItems], head[kItems], tail[kItems];
    int first = INT_MAX;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = key[i + 1];
      valid[i] = k < n;
      head[i] = valid[i] && key[i] != k;
      tail[i] = valid[i] && key[i + 2] != k;
      if (head[i]) first = min(first, j0 + i);
    }
    first = __reduce_min_sync(kFull, first);
    if (lane == 0) s_first_head[warp] = first;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) first = min(first, s_first_head[w]);

    // Owned slots: in the chunk, those at or after its first head; past
    // it, those before the tile's first head (the last run's tail).
    bool owned[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = j0 + i;
      owned[i] = valid[i] &&
                 (own_tile ? (carry.head || j >= first) : j < first);
    }

    // The owned slots' gradients, gathered through the permutation, and
    // the row of each owned run that ends here (-1: no row holds its key).
    float v[kItems][kRows];
    bool ends[kItems];
    int row[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (owned[i]) {
        if constexpr (kLevel == kS2NoStage) {
          const size_t slot = static_cast<size_t>(__ldg(perm + j0 + i));
          const size_t fs = static_cast<size_t>(f);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            v[i][r] = __ldg(src + r * fs + slot);
          }
        } else {
          const size_t slot =
              kLevel == kS1Scan ? static_cast<size_t>(j0 + i)
                                : static_cast<size_t>(__ldg(perm + j0 + i));
          const float* at = src + slot * kRows;
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[i][r] = __ldg(at + r);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[i][r] = 0.0f;
      }
      ends[i] = owned[i] && tail[i];
      row[i] = ends[i] ? __ldg(row_of + key[i + 1]) : -1;
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (row[i] >= 0 && !(row[i] < n_rows &&
                           __ldg(gid_col + row[i]) == key[i + 1])) {
        row[i] = -1;
      }
    }

    // Segmented scan: in order over the thread's slots, across the warp,
    // then over the warps' totals after the carry.
    bool lhead[kItems];
    lhead[0] = head[0];
#pragma unroll
    for (int i = 1; i < kItems; ++i) {
      lhead[i] = head[i] || lhead[i - 1];
      if (!head[i]) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[i][r] = v[i - 1][r] + v[i][r];
      }
    }
    Seg s;
    s.head = lhead[kItems - 1];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s.v[r] = v[kItems - 1][r];
    warp_segmented_scan(s, lane);
    if (lane == 31) {
      s_warp_head[warp] = s.head;
#pragma unroll
      for (int r = 0; r < kRows; ++r) s_warp_v[warp][r] = s.v[r];
    }
    if (tid == kThreads - 1) {
      // Walk on past this tile? In the chunk while slots remain; past it
      // while the owned run goes on through the tile's last slot.
      const int i = kItems - 1;
      s_walk_on = own_tile && t + 1 < kChunkTiles
                      ? valid[i]
                      : owned[i] && !tail[i];
    }
    // The lane's exclusive prefix within the warp.
    Seg lane_prefix;
    lane_prefix.head = __shfl_up_sync(kFull, static_cast<int>(s.head), 1);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      lane_prefix.v[r] = __shfl_up_sync(kFull, s.v[r], 1);
    }
    __syncthreads();

    // prefix = carry, then warps 0 .. warp - 1, then the lane's prefix;
    // the next carry = carry, then every warp.
    Seg prefix = carry;
    Seg next = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      Seg e;
      e.head = s_warp_head[w];
#pragma unroll
      for (int r = 0; r < kRows; ++r) e.v[r] = s_warp_v[w][r];
      e.combine_after(next.head, next.v);
      next = e;
      if (w == warp - 1) prefix = next;
    }
    if (lane > 0) {
      lane_prefix.combine_after(prefix.head, prefix.v);
      prefix = lane_prefix;
    }
    const bool walk_on = s_walk_on;
    carry = next;

#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (row[i] < 0) continue;
      if (!lhead[i]) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[i][r] = prefix.v[r] + v[i][r];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) out[r * ns + row[i]] = v[i][r];
    }
    if (!walk_on) return;
  }
}

// Level kLevel (K5 at kS2Gather) on `stream`: keys int32 [f] ascending;
// perm int64 [f]; grad f32 [9, f] (in key order for kS1Scan); gid_col
// int32 [n_rows] ascending, n past the live rows; out f32 [9, n_rows].
// Scratch: grad_t f32 [f, 9] (unused by kS2NoStage) and row_of int32 [n],
// any contents. n_rows > 0; f must leave room for a tile past it in an
// int.
template <int kLevel>
cudaError_t launch_segment_sums(const int* keys, const long long* perm,
                                const float* grad, int f, const int* gid_col,
                                int n_rows, int n, float* out, float* grad_t,
                                int* row_of, cudaStream_t stream) {
  if (f < 0 || f > INT_MAX - kChunk) return cudaErrorInvalidValue;
  constexpr bool kStage = kLevel != kS2NoStage;
  const int slot_blocks = kStage ? (f + kThreads - 1) / kThreads : 0;
  const int row_blocks = (n_rows + kThreads - 1) / kThreads;
  segment_sums_prep_kernel<<<slot_blocks + row_blocks, kThreads, 0,
                             stream>>>(grad, f, slot_blocks, gid_col, n_rows,
                                       n, grad_t, row_of, out);
  const cudaError_t err = cudaGetLastError();
  if constexpr (kLevel == kS0Prep) {
    return err;
  } else {
    if (err != cudaSuccess || f == 0) return err;
    segment_sums_kernel<kLevel><<<(f + kChunk - 1) / kChunk, kThreads, 0,
                                  stream>>>(keys, perm,
                                            kStage ? grad_t : grad, f,
                                            gid_col, row_of, n_rows, n, out);
    return cudaGetLastError();
  }
}

}  // namespace segsum
}  // namespace
