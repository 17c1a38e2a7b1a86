// Fragment expansion, for sm_90a: K1 (gaussians -> tile rows) and K2 (tile
// rows -> fragments) of the two-level binning, and K7 (gaussians -> the
// fragments of their whole tile bbox) of the one-level binning.
//
// K1 replaces wgpu_3dgs_core_tpu/ops/expand.py::_expand_row_kernel
//    (launcher expand_rows, pl.pallas_call at expand.py:647).
// K2 replaces wgpu_3dgs_core_tpu/ops/expand.py::_expand_attr_kernel
//    (launcher expand_fragments_with_attrs, pl.pallas_call at expand.py:438).
// K7 replaces wgpu_3dgs_core_tpu/ops/expand.py::_expand_kernel
//    (launcher expand_fragments, pl.pallas_call at expand.py:386): K2's
//    (dy, dx) decode without attributes, writing only the tile and gid
//    rows (8 B a slot; its bound is 20 B a live table row, the five
//    columns it reads, and 8 B a slot).
//
// What they compute: a segment table (ops/expand.py SegmentTable) gives
// each of its n rows a run [off, off + cnt) of output slots. For every
// output slot below the device-resident `total`, the thread finds the
// owning row and writes that row's fields, plus the slot's rank inside
// the run; slots at or past `total` get the padding values. Everything is
// integer arithmetic and copies, so the outputs equal the plain torch
// versions (searchsorted + gathers) bit for bit.
//
// What bounds them on the card: memory. Each slot writes 56 B (K1: 4 int32
// + 10 f32) or 48 B (K2: 2 int32 + 10 f32) and reads its owner's row; the
// owner search is a ~log2(n) binary search whose upper levels every warp
// shares, so it runs out of L1/L2. At 1080p K2 writes ~3M slots, ~140 MB.
//
// Design of K1 and K2: one thread per output slot over the whole
// capacity, reading `total` from device memory (no host sync, no
// unwritten tail to mask). Neighbouring slots mostly share an owner (runs
// are contiguous), so the row gathers coalesce and the slot-major writes
// are fully coalesced. The TPU version's one-hot MXU gather, base-256
// digit tables and bf16 splits existed only for the MXU and are not
// carried over.
//
// Design of K7: K7 writes only 8 B a slot, so a ~20-load binary search
// per slot over the whole table (its first design, kept in variants.cu)
// took 4x its bound. Each block now takes a fixed stretch of the merge of
// the row offsets with the slots (a load-balancing search): two warps
// find the stretch's ends with 32-ary searches, the block loads the
// offsets of the rows it meets into shared memory with coalesced reads,
// and each thread finds its slots' owners there and writes coalesced.
// Rows with no slots take merge steps too, so a mostly culled table still
// bounds each block's work. ops/expand.py::merge_path_partition_plain
// mirrors the partition for the CPU tests.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// K1 output int rows (ops/expand.py ROW_X0 .. ROW_GID).
constexpr int kRowX0 = 0;
constexpr int kRowRow = 1;
constexpr int kRowSpanX = 2;
constexpr int kRowGid = 3;
constexpr int kRowInts = 4;

__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const int* __restrict__ tab, const float* __restrict__ attr,
                   int n, int a_rows, const int* __restrict__ total_ptr,
                   int cap, int* __restrict__ out_i,
                   float* __restrict__ out_f) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= cap) return;
  const size_t cs = static_cast<size_t>(cap);
  const int total = __ldg(total_ptr);
  if (s < total) {
    const int* off = tab + GS_TAB_OFF * n;
    const int g = gs_owner(off, n, s);
    const int rank = s - __ldg(off + g);
    out_i[kRowX0 * cs + s] = __ldg(tab + GS_TAB_X0 * n + g);
    out_i[kRowRow * cs + s] = __ldg(tab + GS_TAB_Y0 * n + g) + rank;
    out_i[kRowSpanX * cs + s] = __ldg(tab + GS_TAB_SPAN * n + g);
    out_i[kRowGid * cs + s] = __ldg(tab + GS_TAB_GID * n + g);
    for (int k = 0; k < a_rows; ++k) {
      out_f[k * cs + s] = __ldg(attr + static_cast<size_t>(k) * n + g);
    }
  } else {
    for (int r = 0; r < kRowInts; ++r) out_i[r * cs + s] = 0;
    for (int k = 0; k < a_rows; ++k) out_f[k * cs + s] = 0.0f;
  }
}

// Tile of a slot of rank `rank` in row g's run: (y0 + dy) * tiles_x + x0 +
// dx with (dy, dx) = divmod(rank, max(span, 1)) (ops/expand.py
// _slot_tiles).
__device__ __forceinline__ int slot_tile(const int* __restrict__ tab, int n,
                                         int g, int rank, int tiles_x) {
  const int span = max(__ldg(tab + GS_TAB_SPAN * n + g), 1);
  const int dy = rank / span;
  const int dx = rank - dy * span;
  return (__ldg(tab + GS_TAB_Y0 * n + g) + dy) * tiles_x +
         __ldg(tab + GS_TAB_X0 * n + g) + dx;
}

__global__ void __launch_bounds__(kThreads)
expand_fragments_kernel(const int* __restrict__ tab,
                        const float* __restrict__ attr, int n, int a_rows,
                        const int* __restrict__ total_ptr, int cap,
                        int tiles_x, int t_total, int* __restrict__ out_i,
                        float* __restrict__ out_f) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= cap) return;
  const size_t cs = static_cast<size_t>(cap);
  const int total = __ldg(total_ptr);
  if (s < total) {
    const int* off = tab + GS_TAB_OFF * n;
    const int g = gs_owner(off, n, s);
    const int rank = s - __ldg(off + g);
    const int gid = __ldg(tab + GS_TAB_GID * n + g);
    out_i[s] = slot_tile(tab, n, g, rank, tiles_x);
    out_i[cs + s] = gid;
    for (int k = 0; k < a_rows; ++k) {
      out_f[k * cs + s] = __ldg(attr + static_cast<size_t>(k) * n + g);
    }
    out_f[a_rows * cs + s] = static_cast<float>(gid);
  } else {
    out_i[s] = t_total;
    out_i[cs + s] = 0;
    for (int k = 0; k <= a_rows; ++k) out_f[k * cs + s] = 0.0f;
  }
}

// K7's blocks: each takes kMergeItems steps of the merge of the table's
// row offsets with the slots [0, cap) (a row before a slot when its
// offset is <= the slot), so a block meets at most kMergeItems + 1 rows
// and kMergeItems slots, whatever the counts: 8 steps a thread, and the
// block's row offsets in 2049 int32 of shared memory (8 KB, so eight
// blocks fit an SM).
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 2048;

// Rows of the merge taken before diagonal d: the smallest i in
// [max(0, d - cap), min(d, n)] with off[i] > d - 1 - i (the merge path
// of moderngpu's load-balancing search, upper-bound form). A warp
// searches together: 32 probes a round cut the range 32-fold, so a range
// of 5M rows takes 5 dependent loads where a binary search takes 23.
// Every lane returns the result.
__device__ __forceinline__ int merge_path_warp(const int* __restrict__ off,
                                               int n, int cap, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - cap);
  int hi = min(d, n);
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + lane * step;
    const bool before = q < hi && __ldg(off + q) <= d - 1 - q;
    // The probes that precede the diagonal are a prefix of the lanes.
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    const int new_hi = c < 32 ? min(lo + c * step, hi) : hi;
    lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    hi = new_hi;
  }
  return lo;
}

__global__ void __launch_bounds__(kMergeThreads)
expand_bbox_kernel(const int* __restrict__ tab, int n,
                   const int* __restrict__ total_ptr, int cap, int tiles_x,
                   int t_total, int* __restrict__ out) {
  __shared__ int s_off[kMergeItems + 1];
  __shared__ int s_part[2];
  const int* off = tab + GS_TAB_OFF * n;
  const int d0 = blockIdx.x * kMergeItems;
  const int d1 = min(d0 + kMergeItems, n + cap);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int i = merge_path_warp(off, n, cap, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) s_part[warp] = i;
  }
  __syncthreads();
  const int i0 = s_part[0];
  const int i1 = s_part[1];
  const int j0 = d0 - i0;
  const int j1 = d1 - i1;
  // Slot j's owner is the last row with offset <= j: row i0 - 1 (taken
  // before the block) up to row i1 - 1. Row 0 stands in for a slot no
  // row's offset reaches, as the plain version's clamp does.
  const int r0 = max(i0 - 1, 0);
  const int rows = i1 - r0;
  for (int r = threadIdx.x; r < rows; r += kMergeThreads) {
    s_off[r] = __ldg(off + r0 + r);
  }
  __syncthreads();
  const int total = __ldg(total_ptr);
  const size_t cs = static_cast<size_t>(cap);
  for (int j = j0 + threadIdx.x; j < j1; j += kMergeThreads) {
    if (j < total && n > 0) {
      int lo = 0;
      int hi = rows;
      while (lo < hi) {  // rows of the block with offset <= j
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= j) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int r = max(lo - 1, 0);
      // The owner's other columns from global memory: a warp's slots
      // share a few owners, so these loads hit L1 (staging them in shared
      // memory, 20 KB more a block, measured slower).
      out[j] = slot_tile(tab, n, r0 + r, j - s_off[r], tiles_x);
      out[cs + j] = __ldg(tab + GS_TAB_GID * n + r0 + r);
    } else {
      out[j] = t_total;
      out[cs + j] = 0;
    }
  }
}

}  // namespace

GS_EXPORT const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// tab: int32 [GS_TAB_ROWS, n]; attr: f32 [a_rows, n]; total: int32 [1];
// out_i: int32 [4, cap] (x0, row, span_x, gid); out_f: f32 [a_rows, cap].
// cap > 0: the caller launches nothing for an empty capacity.
GS_EXPORT int gs_expand_rows(const int* tab, const float* attr, int n,
                             int a_rows, const int* total, int cap,
                             int* out_i, float* out_f, void* stream) {
  const int blocks = (cap + kThreads - 1) / kThreads;
  expand_rows_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      tab, attr, n, a_rows, total, cap, out_i, out_f);
  return static_cast<int>(cudaGetLastError());
}

// tab: int32 [GS_TAB_ROWS, n]; attr: f32 [a_rows, n]; total: int32 [1];
// out_i: int32 [2, cap] (tile, gid); out_f: f32 [a_rows + 1, cap] (the
// attributes, then gid as f32). cap > 0, as above.
GS_EXPORT int gs_expand_fragments(const int* tab, const float* attr, int n,
                                  int a_rows, const int* total, int cap,
                                  int tiles_x, int t_total, int* out_i,
                                  float* out_f, void* stream) {
  const int blocks = (cap + kThreads - 1) / kThreads;
  expand_fragments_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      tab, attr, n, a_rows, total, cap, tiles_x, t_total, out_i, out_f);
  return static_cast<int>(cudaGetLastError());
}

// tab: int32 [GS_TAB_ROWS, n] (ops/expand.py build_segment_table); total:
// int32 [1]; out: int32 [2, cap] (tile, gid). cap > 0, as above.
GS_EXPORT int gs_expand_bbox(const int* tab, int n, const int* total,
                             int cap, int tiles_x, int t_total, int* out,
                             void* stream) {
  const int blocks = static_cast<int>(
      (static_cast<long long>(n) + cap + kMergeItems - 1) / kMergeItems);
  expand_bbox_kernel<<<blocks, kMergeThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      tab, n, total, cap, tiles_x, t_total, out);
  return static_cast<int>(cudaGetLastError());
}
