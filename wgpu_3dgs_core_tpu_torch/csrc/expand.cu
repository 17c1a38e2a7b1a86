// Fragment expansion, for sm_90a: K1 (gaussians -> tile rows) and K2 (tile
// rows -> fragments) of the two-level binning, and K7 (gaussians -> the
// fragments of their whole tile bbox) of the one-level binning.
//
// K1 replaces wgpu_3dgs_core_tpu/ops/expand.py::_expand_row_kernel
//    (launcher expand_rows, pl.pallas_call at expand.py:647). Its row-table
//    form (launcher ops/binning.py::expand_row_table) also evaluates each
//    row's exact tile interval (ops/binning.py::_row_tile_span) and writes
//    the per-row table K2 reads (ops/binning.py::row_table), all but its
//    offset row: the render path's K1.
// K2 replaces wgpu_3dgs_core_tpu/ops/expand.py::_expand_attr_kernel
//    (launcher expand_fragments_with_attrs, pl.pallas_call at expand.py:438).
//    Its record form (launcher ops/expand.py::expand_fragment_records,
//    the render path's K2) writes each slot's attributes as one 48-B
//    record for K14.
// K14 has no TPU counterpart (the JAX package's binning gathers the
//    attribute rows through the sort's permutation with XLA): it reads
//    K2's records through the tile sort's permutation and writes the
//    rasterizer's tile-local [9, F] stream and the int32 gid
//    (launcher ops/binning.py::sorted_fetch), what the plain version
//    ops/binning.py::sorted_fetch_plain builds from a row gather,
//    tile_local_stream and a cast.
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
// the run; slots at or past `total` get the padding values. Everything but
// the row-table form's interval is integer arithmetic and copies, and that
// interval rounds each float operation once in torch's order, so the
// outputs equal the plain torch versions (searchsorted + gathers, and
// _row_tile_span) bit for bit.
//
// What bounds them on the card: memory. Each slot writes 56 B (K1: 4 int32
// + 10 f32; its row-table form 5 int32 + 9 f32, and the cumsum after it
// the offset's 4 B) or 48 B (K2: 2 int32 + 10 f32; its record form 52 B,
// the tile and the record) and reads its owner's row; the owner search is
// a ~log2(n) binary search whose upper levels every warp shares, so it
// runs out of L1/L2. At 1080p K2 writes ~3M slots, ~140 MB.
//
// Design of K1 and K2: one thread per output slot over the whole
// capacity, reading `total` from device memory (no host sync, no
// unwritten tail to mask). Neighbouring slots mostly share an owner (runs
// are contiguous), so the row gathers coalesce and the slot-major writes
// are fully coalesced. The TPU version's one-hot MXU gather, base-256
// digit tables and bf16 splits existed only for the MXU and are not
// carried over.
//
// Design of K14: a [10, F] row gather through the permutation reads ten
// scattered 4-B values a slot, one 32-B sector each. K2's record form
// puts a slot's attributes and gid in one 48-B record, 16-B aligned, so
// a slot of the sorted stream reads its record with three 16-B loads
// from two sectors, besides its permutation entry and tile, read
// coalesced, and writes its ten 4-B values coalesced, 40 B. A padding
// slot (tile t_total) reads no record: its record is zeros. The tile
// origin is subtracted in f32, rounded once, as the plain version's
// torch ops do, so the stream equals theirs bit for bit.
//
// Design of K7: K7 writes only 8 B a slot, so a ~20-load binary search
// per slot over the whole table (its first design) took 4x its bound.
// Each block now takes a fixed stretch of the merge of the row offsets
// with the slots (a load-balancing search): two warps find the stretch's
// ends with 32-ary searches, the block loads the offsets of the rows it
// meets into shared memory with coalesced reads, and each thread finds
// its slots' owners there and writes coalesced.
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

// K2's record form (ops/expand.py RECORD_*): the kRecordAttrs blend
// attributes, the gid's int32 bits, zeros up to kRecordFloats (48 B, three
// float4).
constexpr int kRecordAttrs = 9;
constexpr int kRecordGid = 9;
constexpr int kRecordFloats = 12;
constexpr int kRecordVecs = kRecordFloats / 4;
static_assert(kRecordGid == kRecordAttrs && kRecordFloats % 4 == 0,
              "K14 reads the attributes, then the gid, from three float4");

// TILE_SIZE and ROW_TRIM_EPS of ops/binning.py.
constexpr float kTileSize = 16.0f;
constexpr int kTilePx = 16;
constexpr float kRowTrimEps = 0.05f;

// The attribute rows the row-table form reads for the interval
// (ops/binning.py::gaussian_table's attr10: x, y, conic a/b/c, r, g, b,
// opacity, then ry).
constexpr int kAttrX = 0;
constexpr int kAttrY = 1;
constexpr int kAttrA = 2;
constexpr int kAttrB = 3;
constexpr int kAttrC = 4;

// torch's float ops as its kernels compute them, so the row interval
// equals the plain version's bit for bit. clamp_min(x, lo) keeps a NaN x;
// maximum and minimum give NaN if either side is one; clamp(x, lo, hi)
// with tensor bounds is minimum(maximum(x, lo), hi).
__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float t_maximum(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a > b ? a : b);
}

__device__ __forceinline__ float t_minimum(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a < b ? a : b);
}

__device__ __forceinline__ float t_clamp(float x, float lo, float hi) {
  return t_minimum(t_maximum(x, lo), hi);
}

// k * sqrt(clamp_min(ry^2 - dy^2, 0)): the support's half-width at dy.
__device__ __forceinline__ float row_width(float k, float ry, float dy) {
  return __fmul_rn(k, __fsqrt_rn(t_clamp_min(
      __fsub_rn(__fmul_rn(ry, ry), __fmul_rn(dy, dy)), 0.0f)));
}

// ops/binning.py::_row_tile_span for one row: torch's operations in its
// order, each rounded once (the _rn intrinsics keep nvcc from contracting
// a multiply and an add into an FMA). The clamps bound both ends inside
// the bbox, so only a NaN interval (a non-finite centre or conic) leaves
// the int32 range; __float2int_rz makes it 0, an empty row, as
// _row_tile_span's nan_to_num does. Returns (tx0, cnt) in *tx0, *cnt.
__device__ __forceinline__ void row_tile_span(float tx0_bbox, float row,
                                              float span_x, float ry,
                                              float cx, float cy, float ca,
                                              float cb, float cc, int* tx0,
                                              int* cnt) {
  const float a_safe = t_clamp_min(ca, 1e-12f);
  const float beta = __fdiv_rn(cb, a_safe);
  const float d = t_clamp_min(
      __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb)), 0.0f);
  const float k = __fdiv_rn(__fsqrt_rn(d), a_safe);
  const float dyg = __fdiv_rn(
      __fmul_rn(cb, ry),
      t_clamp_min(__fsqrt_rn(t_clamp_min(__fmul_rn(ca, cc), 0.0f)),
                  1e-12f));

  const float y_px = __fmul_rn(row, kTileSize);
  const float d_lo = t_clamp(__fsub_rn(y_px, cy), -ry, ry);
  const float d_hi =
      t_clamp(__fsub_rn(__fadd_rn(y_px, kTileSize), cy), -ry, ry);
  const float c_max = t_clamp(-dyg, d_lo, d_hi);
  const float c_min = t_clamp(dyg, d_lo, d_hi);

  const float nb = -beta;
  const float w_lo = row_width(k, ry, d_lo);
  const float w_hi = row_width(k, ry, d_hi);
  const float xmax = t_maximum(
      t_maximum(__fadd_rn(__fmul_rn(nb, d_lo), w_lo),
                __fadd_rn(__fmul_rn(nb, d_hi), w_hi)),
      __fadd_rn(__fmul_rn(nb, c_max), row_width(k, ry, c_max)));
  const float xmin = t_minimum(
      t_minimum(__fsub_rn(__fmul_rn(nb, d_lo), w_lo),
                __fsub_rn(__fmul_rn(nb, d_hi), w_hi)),
      __fsub_rn(__fmul_rn(nb, c_min), row_width(k, ry, c_min)));

  float lo = floorf(
      __fdiv_rn(__fsub_rn(__fadd_rn(cx, xmin), kRowTrimEps), kTileSize));
  float hi = __fadd_rn(
      floorf(__fdiv_rn(__fadd_rn(__fadd_rn(cx, xmax), kRowTrimEps),
                       kTileSize)),
      1.0f);
  lo = t_clamp(lo, tx0_bbox, __fsub_rn(__fadd_rn(tx0_bbox, span_x), 1.0f));
  hi = t_clamp(hi, __fadd_rn(lo, 1.0f), __fadd_rn(tx0_bbox, span_x));
  *tx0 = __float2int_rz(lo);
  *cnt = __float2int_rz(__fsub_rn(hi, lo));
}

// K1. Row-stream form (kTable false): each slot's (x0, row, span_x, gid)
// and all a_rows attribute rows. Row-table form (kTable true): the row's
// exact tile interval in registers, written as the per-row table's
// fields (count, max(count, 1), tx0, tile row, gid; not the offsets) and
// the a_rows - 1 blend attributes before ry. Slots at or past `total`
// get zeros, and in the table a span of 1, as row_table's live mask
// gives them.
template <bool kTable>
__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const int* __restrict__ tab, const float* __restrict__ attr,
                   int n, int a_rows, const int* __restrict__ total_ptr,
                   int cap, int* __restrict__ out_i,
                   float* __restrict__ out_f) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= cap) return;
  const size_t cs = static_cast<size_t>(cap);
  const size_t sn = static_cast<size_t>(n);
  const int total = __ldg(total_ptr);
  const int copied = kTable ? a_rows - 1 : a_rows;
  if (s < total) {
    const int* off = tab + GS_TAB_OFF * n;
    const int g = gs_owner(off, n, s);
    const int rank = s - __ldg(off + g);
    const int x0 = __ldg(tab + GS_TAB_X0 * n + g);
    const int row = __ldg(tab + GS_TAB_Y0 * n + g) + rank;
    const int span = __ldg(tab + GS_TAB_SPAN * n + g);
    const int gid = __ldg(tab + GS_TAB_GID * n + g);
    if constexpr (kTable) {
      int tx0, cnt;
      row_tile_span(static_cast<float>(x0), static_cast<float>(row),
                    static_cast<float>(span),
                    __ldg(attr + static_cast<size_t>(copied) * sn + g),
                    __ldg(attr + kAttrX * sn + g),
                    __ldg(attr + kAttrY * sn + g),
                    __ldg(attr + kAttrA * sn + g),
                    __ldg(attr + kAttrB * sn + g),
                    __ldg(attr + kAttrC * sn + g), &tx0, &cnt);
      out_i[GS_TAB_CNT * cs + s] = cnt;
      out_i[GS_TAB_SPAN * cs + s] = max(cnt, 1);
      out_i[GS_TAB_X0 * cs + s] = tx0;
      out_i[GS_TAB_Y0 * cs + s] = row;
      out_i[GS_TAB_GID * cs + s] = gid;
    } else {
      out_i[kRowX0 * cs + s] = x0;
      out_i[kRowRow * cs + s] = row;
      out_i[kRowSpanX * cs + s] = span;
      out_i[kRowGid * cs + s] = gid;
    }
    for (int k = 0; k < copied; ++k) {
      out_f[k * cs + s] = __ldg(attr + static_cast<size_t>(k) * sn + g);
    }
  } else {
    if constexpr (kTable) {
      for (int r = 0; r < GS_TAB_ROWS; ++r) {
        if (r != GS_TAB_OFF) out_i[r * cs + s] = r == GS_TAB_SPAN ? 1 : 0;
      }
    } else {
      for (int r = 0; r < kRowInts; ++r) out_i[r * cs + s] = 0;
    }
    for (int k = 0; k < copied; ++k) out_f[k * cs + s] = 0.0f;
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

// K2. Row form (kRecord false): out_i [2, cap] (tile, gid), out_f
// [a_rows + 1, cap] (the attributes, then gid as f32). Record form
// (kRecord true, a_rows == kRecordAttrs): out_i [cap] (tile), out_f
// [cap, kRecordFloats] (a record a slot). Slots at or past `total` get
// tile t_total and zeros.
template <bool kRecord>
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
  float rec[kRecordFloats] = {};
  if (s < total) {
    const int* off = tab + GS_TAB_OFF * n;
    const int g = gs_owner(off, n, s);
    const int rank = s - __ldg(off + g);
    const int gid = __ldg(tab + GS_TAB_GID * n + g);
    out_i[s] = slot_tile(tab, n, g, rank, tiles_x);
    if constexpr (kRecord) {
#pragma unroll
      for (int k = 0; k < kRecordAttrs; ++k) {
        rec[k] = __ldg(attr + static_cast<size_t>(k) * n + g);
      }
      rec[kRecordGid] = __int_as_float(gid);
    } else {
      out_i[cs + s] = gid;
      for (int k = 0; k < a_rows; ++k) {
        out_f[k * cs + s] = __ldg(attr + static_cast<size_t>(k) * n + g);
      }
      out_f[a_rows * cs + s] = static_cast<float>(gid);
    }
  } else {
    out_i[s] = t_total;
    if constexpr (!kRecord) {
      out_i[cs + s] = 0;
      for (int k = 0; k <= a_rows; ++k) out_f[k * cs + s] = 0.0f;
    }
  }
  if constexpr (kRecord) {
    float4* dst = reinterpret_cast<float4*>(out_f) +
                  static_cast<size_t>(s) * kRecordVecs;
#pragma unroll
    for (int v = 0; v < kRecordVecs; ++v) {
      dst[v] = make_float4(rec[4 * v], rec[4 * v + 1], rec[4 * v + 2],
                           rec[4 * v + 3]);
    }
  }
}

// K14: slot j of the tile-sorted stream from the record at perm[j] (a
// live slot; a padding slot's record is zeros and is not read): x and y
// less the origin of tile[j], then the conic, rgb and opacity, into
// frags [kRecordAttrs, cap], and the gid into gid [cap].
__global__ void __launch_bounds__(kThreads)
sorted_fetch_kernel(const float4* __restrict__ rec,
                    const long long* __restrict__ perm,
                    const int* __restrict__ tile, int cap, int tiles_x,
                    int t_total, float* __restrict__ frags,
                    int* __restrict__ gid) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= cap) return;
  const size_t cs = static_cast<size_t>(cap);
  const int t = __ldg(tile + j);
  float4 v[kRecordVecs];
#pragma unroll
  for (int k = 0; k < kRecordVecs; ++k) v[k] = make_float4(0, 0, 0, 0);
  if (t < t_total) {
    const float4* r = rec + __ldg(perm + j) * kRecordVecs;
#pragma unroll
    for (int k = 0; k < kRecordVecs; ++k) v[k] = __ldg(r + k);
  }
  // torch.remainder and floor division of a tile id >= 0 by tiles_x; the
  // origin, an int below 2^24, is exact in f32.
  const int row = t / tiles_x;
  const int col = t - row * tiles_x;
  frags[j] = __fsub_rn(v[0].x, static_cast<float>(col * kTilePx));
  frags[cs + j] = __fsub_rn(v[0].y, static_cast<float>(row * kTilePx));
  frags[2 * cs + j] = v[0].z;
  frags[3 * cs + j] = v[0].w;
  frags[4 * cs + j] = v[1].x;
  frags[5 * cs + j] = v[1].y;
  frags[6 * cs + j] = v[1].z;
  frags[7 * cs + j] = v[1].w;
  frags[8 * cs + j] = v[2].x;
  gid[j] = __float_as_int(v[2].y);
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
  expand_rows_kernel<false><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      tab, attr, n, a_rows, total, cap, out_i, out_f);
  return static_cast<int>(cudaGetLastError());
}

// tab: int32 [GS_TAB_ROWS, n]; attr: f32 [a_rows, n] (the 9 blend
// attributes, then ry); total: int32 [1]; out_i: int32 [GS_TAB_ROWS, cap],
// every row but GS_TAB_OFF written; out_f: f32 [a_rows - 1, cap]. cap > 0,
// as above.
GS_EXPORT int gs_expand_row_table(const int* tab, const float* attr, int n,
                                  int a_rows, const int* total, int cap,
                                  int* out_i, float* out_f, void* stream) {
  const int blocks = (cap + kThreads - 1) / kThreads;
  expand_rows_kernel<true><<<blocks, kThreads, 0,
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
  expand_fragments_kernel<false><<<blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      tab, attr, n, a_rows, total, cap, tiles_x, t_total, out_i, out_f);
  return static_cast<int>(cudaGetLastError());
}

// tab: int32 [GS_TAB_ROWS, n]; attr: f32 [kRecordAttrs, n]; total: int32
// [1]; out_tile: int32 [cap]; out_rec: f32 [cap, kRecordFloats], 16-B
// aligned. cap > 0, as above.
GS_EXPORT int gs_expand_fragment_records(const int* tab, const float* attr,
                                         int n, const int* total, int cap,
                                         int tiles_x, int t_total,
                                         int* out_tile, float* out_rec,
                                         void* stream) {
  const int blocks = (cap + kThreads - 1) / kThreads;
  expand_fragments_kernel<true><<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      tab, attr, n, kRecordAttrs, total, cap, tiles_x, t_total, out_tile,
      out_rec);
  return static_cast<int>(cudaGetLastError());
}

// rec: f32 [cap, kRecordFloats] (K2's record form), 16-B aligned; perm:
// int64 [cap], the tile sort's permutation; tile: int32 [cap], the sorted
// tiles; frags: f32 [kRecordAttrs, cap]; gid: int32 [cap]. cap > 0, as
// above.
GS_EXPORT int gs_sorted_fetch(const float* rec, const long long* perm,
                              const int* tile, int cap, int tiles_x,
                              int t_total, float* frags, int* gid,
                              void* stream) {
  const int blocks = (cap + kThreads - 1) / kThreads;
  sorted_fetch_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rec), perm, tile, cap, tiles_x,
      t_total, frags, gid);
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
