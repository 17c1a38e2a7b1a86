// Segment reduction of the backward's per-fragment gradients: K5 (sums per
// gaussian over the gid-sorted stream) and K6 (back to the original
// gaussian order), for sm_90a.
//
// K5 replaces wgpu_3dgs_core_tpu/ops/segreduce.py::_segsum_kernel
//    (launcher segment_sums_sorted, pl.pallas_call at segreduce.py:362).
// K6 replaces wgpu_3dgs_core_tpu/ops/segreduce.py::_uncompact_kernel
//    (launcher uncompact_columns, pl.pallas_call at segreduce.py:404).
//
// What they compute: after K4 and one sort of the slots by key (the
// gaussian id of a drawn slot, n + slot for the rest), K5 sums, for each
// row r of the ascending compacted gid column, the 9 gradient rows of the
// sorted slots whose key equals gid[r]. Ownership is by key equality, so
// fragments missing from the stream contribute nothing and shift nothing.
// K6 writes, for every original gaussian g, the column of the row holding
// g, or exact zeros where g has no fragments.
//
// What bounds them on the card: memory. K5 reads 48 B per drawn slot (key,
// int64 permutation index, 9 gradients gathered through the permutation)
// and writes 36 B per row; K6 reads the gid column and 36 B per live row
// and writes 36 B per gaussian.
//
// Design: K5 runs one warp per compacted row. Every lane binary-searches
// the row's run [lo, hi) in the sorted keys (the same addresses, so the
// loads broadcast), the lanes stride over the run reading the gradient
// rows through the sort's permutation (no sorted [9, F] copy), and a warp
// butterfly in a fixed order sums them: the sums are deterministic, with
// no atomics. K6 runs one thread per original gaussian with K1's owner
// search over the gid column. Every output slot of both is written. The
// TPU version's one-hot MXU window matmuls, exact bf16 splits, panel
// flushes and NaN scrub existed only for the MXU (K4 writes every slot,
// so nothing here can read an unwritten NaN).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 9;

__global__ void __launch_bounds__(kThreads)
segment_sums_kernel(const int* __restrict__ keys,
                    const long long* __restrict__ perm,
                    const float* __restrict__ grad, int f,
                    const int* __restrict__ gid_col, int n_rows, int n,
                    float* __restrict__ out) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warps: kThreads is a multiple of 32
  const size_t fs = static_cast<size_t>(f);
  const int gid = __ldg(gid_col + row);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  if (gid < n) {  // rows past the live ones hold the sentinel n
    const int lo = gs_lower_bound(keys, f, gid);
    const int hi = gs_lower_bound(keys, f, gid + 1);
    for (int j = lo + lane; j < hi; j += 32) {
      const size_t src = static_cast<size_t>(__ldg(perm + j));
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += __ldg(grad + r * fs + src);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
  }
  if (lane == 0) {
    const size_t ns = static_cast<size_t>(n_rows);
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r * ns + row] = acc[r];
  }
}

__global__ void __launch_bounds__(kThreads)
uncompact_kernel(const float* __restrict__ comp,
                 const int* __restrict__ gid_col, int n_rows, int n,
                 float* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const int row = gs_lower_bound(gid_col, n_rows, g);
  const bool found = row < n_rows && __ldg(gid_col + row) == g;
  const size_t ns = static_cast<size_t>(n_rows);
  const size_t no = static_cast<size_t>(n);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    out[r * no + g] = found ? __ldg(comp + r * ns + row) : 0.0f;
  }
}

}  // namespace

// keys: int32 [f] ascending; perm: int64 [f], the sort's permutation (slot
// of each sorted key); grad: f32 [9, f] in slot order; gid_col: int32
// [n_rows] ascending, n past the live rows; out: f32 [9, n_rows].
// n_rows > 0: the caller launches nothing for an empty table.
GS_EXPORT int gs_segment_sums(const int* keys, const long long* perm,
                              const float* grad, int f, const int* gid_col,
                              int n_rows, int n, float* out, void* stream) {
  const int warps_per_block = kThreads / 32;
  const int blocks = (n_rows + warps_per_block - 1) / warps_per_block;
  segment_sums_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      keys, perm, grad, f, gid_col, n_rows, n, out);
  return static_cast<int>(cudaGetLastError());
}

// comp: f32 [9, n_rows] (K5's output); gid_col as above; out: f32 [9, n].
// n > 0, as above.
GS_EXPORT int gs_uncompact(const float* comp, const int* gid_col, int n_rows,
                           int n, float* out, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  uncompact_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(comp, gid_col,
                                                          n_rows, n, out);
  return static_cast<int>(cudaGetLastError());
}
