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
//    owner search and (dy, dx) decode without attributes, writing only the
//    tile and gid rows (8 B a slot; its bound is 20 B a live table row,
//    the five columns it reads, and 8 B a slot).
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
// Design: one thread per output slot over the whole capacity, reading
// `total` from device memory (no host sync, no unwritten tail to mask).
// Neighbouring slots mostly share an owner (runs are contiguous), so the
// row gathers coalesce and the slot-major writes are fully coalesced. The
// TPU version's one-hot MXU gather, base-256 digit tables and bf16 splits
// existed only for the MXU and are not carried over.

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

__global__ void __launch_bounds__(kThreads)
expand_bbox_kernel(const int* __restrict__ tab, int n,
                   const int* __restrict__ total_ptr, int cap, int tiles_x,
                   int t_total, int* __restrict__ out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= cap) return;
  const size_t cs = static_cast<size_t>(cap);
  if (s < __ldg(total_ptr)) {
    const int* off = tab + GS_TAB_OFF * n;
    const int g = gs_owner(off, n, s);
    out[s] = slot_tile(tab, n, g, s - __ldg(off + g), tiles_x);
    out[cs + s] = __ldg(tab + GS_TAB_GID * n + g);
  } else {
    out[s] = t_total;
    out[cs + s] = 0;
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
  const int blocks = (cap + kThreads - 1) / kThreads;
  expand_bbox_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      tab, n, total, cap, tiles_x, t_total, out);
  return static_cast<int>(cudaGetLastError());
}
