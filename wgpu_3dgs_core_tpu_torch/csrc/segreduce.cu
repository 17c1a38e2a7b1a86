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
// K5's design: lanes over the sorted slots, not over rows. sort_keys keys
// every slot the rasterizer did not draw past every gaussian (n + slot),
// so the drawn slots are the prefix of the keys below n, and a run of
// equal keys there is one gaussian's fragments. Each block takes a chunk
// of kChunk consecutive slots, walked in tiles of kTile: each thread
// holds kItems consecutive slots of a tile. A run's head is its first
// slot (j = 0 or keys[j - 1] != keys[j]); a block owns the runs whose
// head lies in its chunk, and after its chunk it walks on, tile by tile,
// until its last run ends. So every run is summed by one block: no
// atomics, no carry between blocks, and a run longer than a chunk is
// walked by its owner. A block whose chunk starts past the drawn prefix
// exits at once, so no host sync finds the prefix's end. The sums are a
// segmented inclusive scan over the head flags: in order within a
// thread, then warp shuffles, then one pass over the warps' totals in
// shared memory, then the carry from the tile before; the order depends
// only on the stream, never on scheduling, so two runs give the same
// bits. The thread holding a run's last slot writes its 9 sums to the row
// holding its key.
//
// The gather through the permutation is what the card pays for. Read from
// the [9, F] gradients, a slot's 9 values lie in 9 sectors of an array
// larger than L2, and the gather took most of the kernel's time. So a
// first kernel (segment_sums_prep_kernel) copies the gradients slot-major
// into scratch, [F, 9], contiguous on both sides, where a slot's values
// share one or two sectors. The same kernel writes each live gaussian's
// row into a scratch map indexed by gaussian, so a run finds its row
// with one load (checked against the gid column, so the map needs no
// clearing) instead of a binary search, and zeroes the output: rows no
// run reaches (live gaussians with no drawn slot, the sentinel rows) stay
// zeros. Both kernels live in segsum.cuh, templated on the levels of K10,
// which compiles the same source for its levels (csrc/variants.cu); K5's
// first design (a warp per row) is variants.cu's
// segment_sums_first_kernel, kept as a measurement record.
//
// K6 runs one thread per original gaussian with K1's owner search over
// the gid column. Every output slot is written. The TPU version's one-hot
// MXU window matmuls, exact bf16 splits, panel flushes and NaN scrub
// existed only for the MXU (K4 writes every slot, so nothing here can
// read an unwritten NaN).

#include "common.cuh"
#include "segsum.cuh"

namespace {

using segsum::kRows;
using segsum::kThreads;

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
// [n_rows] ascending, n past the live rows; out: f32 [9, n_rows]. Scratch:
// grad_t f32 [f, 9] and row_of int32 [n], any contents. n_rows > 0: the
// caller launches nothing for an empty table. f must leave room for a
// tile past it in an int.
GS_EXPORT int gs_segment_sums(const int* keys, const long long* perm,
                              const float* grad, int f, const int* gid_col,
                              int n_rows, int n, float* out, float* grad_t,
                              int* row_of, void* stream) {
  return static_cast<int>(segsum::launch_segment_sums<segsum::kS2Gather>(
      keys, perm, grad, f, gid_col, n_rows, n, out, grad_t, row_of,
      static_cast<cudaStream_t>(stream)));
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
