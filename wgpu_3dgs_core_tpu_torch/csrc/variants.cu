// The measurement kernels of the rasterizer (K9) and of the segment sums
// (K10), and the first designs of K3, K4, K5 and K7, for sm_90a.
//
// K9 replaces tools/bench_kernel_variants.py::run_variant (pl.pallas_call
//    at bench_kernel_variants.py:239, level bodies in _mk_kernel): K3
//    stripped one ingredient per level, timed over K3's arguments, so the
//    step from one level to the next prices that ingredient. Its levels
//    are instantiations of K3's own body (csrc/rasterize_fwd.cuh, where
//    they are listed): v0_stage, v1_cull, v2_q, v3_alpha, v4_trans,
//    v5_color, v6_full (K3 itself, compiled from the same source) and
//    v7_notrans. The TPU tool's v3_alpha_mxu, v4/v5_cumsum,
//    v6_full_mxuacc and v9_nosum price MXU matmuls and lane-tree sums
//    that K3 does not do: no level here.
//
// K10 replaces tools/bench_segsum.py::run_variant (pl.pallas_call at
//    bench_segsum.py:104, level bodies in _mk_kernel): K5 stripped the
//    same way, over K5's arguments. Its levels are instantiations of K5's
//    own kernels (csrc/segsum.cuh): s0_prep, s1_scan, s2_gather (K5
//    itself) and s2_nostage. The TPU tool's key transpose, one-hot build
//    and HIGHEST contraction have no counterpart on the card.
//
// The first designs (measurement only), each kept as one kernel and
//    timed in turns with its successor:
//    rasterize_fwd_first_kernel, K3 before the pixel-box cull: thread p on
//      row-major pixel p, every pixel evaluating every staged fragment;
//      K3's arguments and its tile, bit for bit.
//    rasterize_bwd_first_kernel, K4 before the cull, where every pixel
//      evaluates every fragment, a warp sums each of its 9 values with a
//      5-step butterfly per fragment and lane 0 makes the nine stores;
//      K4's arguments and its [9, F] gradients.
//    segment_sums_first_kernel, K5 before its lanes went over the sorted
//      slots: one warp per row of the compacted gid column, the row's run
//      found by two lower_bound searches over the keys, the lanes striding
//      over it through the permutation into [9, F], a fixed-order warp
//      butterfly; K5's arguments and its [9, rows] sums (in another
//      order).
//    expand_bbox_first_kernel, K7 before the merge path: one thread per
//      slot over the capacity, each finding its owner by a binary search
//      over the whole table's offsets (common.cuh gs_owner, ~20 dependent
//      loads at 1M rows); K7's arguments and its [2, cap] tile and gid
//      rows.
//
// What bounds them: K9's full level is K3's work (per-(pixel, fragment)
// arithmetic, ~20 flops to evaluate and ~9 to blend); K10's full level is
// K5's work (48 B per drawn slot, 36 B per row). Every level writes a
// result that depends on all the work it did, so nvcc cannot drop any of
// it.

#include "blend.cuh"
#include "common.cuh"
#include "rasterize_fwd.cuh"
#include "segsum.cuh"

namespace {

constexpr int kBwdBatch = 128;    // K4 fragments staged per batch
constexpr int kTailSlots = 4096;  // K4 padding slots zeroed per block

// ------------------------------------------------ K3's first design

// K3's first design (csrc/rasterize.cu before the pixel-box cull): blocks
// [0, n_tiles), one 256-thread block per tile, thread p on row-major pixel
// p, every pixel evaluating every fragment of each staged batch, with
// K3's per-pixel stop and block exit.
__global__ void __launch_bounds__(kPix)
rasterize_fwd_first_kernel(const float* __restrict__ frags, int f_stride,
                           const int* __restrict__ tile_start,
                           const int* __restrict__ tile_len, float bg_r,
                           float bg_g, float bg_b, float cutoff_sq, int mode,
                           float* __restrict__ out) {
  __shared__ float s_frag[kRows][kBatch];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>(p % kTile) + 0.5f;
  const float py = static_cast<float>(p / kTile) + 0.5f;
  const int start = __ldg(tile_start + tile);
  const int len = __ldg(tile_len + tile);
  const float ring_lo = ring_lo_of(cutoff_sq);

  float t = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  bool done = false;

  for (int base = 0; base < len; base += kBatch) {
    if (__syncthreads_count(done) == kPix) break;
    const int count = min(kBatch, len - base);
    if (p < count) {
      const size_t col = static_cast<size_t>(start) + base + p;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s_frag[r][p] = __ldg(frags + static_cast<size_t>(r) * f_stride + col);
      }
    }
    __syncthreads();
    if (done) continue;
    for (int i = 0; i < count; ++i) {
      float alpha, alpha_raw, g_exp, dx, dy;
      if (!frag_alpha(s_frag, i, px, py, cutoff_sq, ring_lo, mode, alpha,
                      alpha_raw, g_exp, dx, dy)) {
        continue;
      }
      const float w = alpha * t;
      acc_r += w * s_frag[5][i];
      acc_g += w * s_frag[6][i];
      acc_b += w * s_frag[7][i];
      t *= 1.0f - alpha;
      if (t <= kTMin) {
        done = true;
        break;
      }
    }
  }

  float* o = out + static_cast<size_t>(tile) * 4 * kPix;
  o[0 * kPix + p] = acc_r + t * bg_r;
  o[1 * kPix + p] = acc_g + t * bg_g;
  o[2 * kPix + p] = acc_b + t * bg_b;
  o[3 * kPix + p] = t;
}

// ------------------------------------------------ K4's first design

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// K4's first design (csrc/rasterize.cu before the pixel-box cull): blocks
// [0, n_tiles) each differentiate one tile, every pixel evaluating every
// drawn fragment; the blocks after them zero the stream's padding slots.
__global__ void __launch_bounds__(kPix)
rasterize_bwd_first_kernel(const float* __restrict__ frags, int f_stride,
                           const int* __restrict__ tile_start,
                           const int* __restrict__ tile_len,
                           const int* __restrict__ draw_len, int n_tiles,
                           const float* __restrict__ out,
                           const float* __restrict__ g_out, float bg_r,
                           float bg_g, float bg_b, float cutoff_sq, int mode,
                           float* __restrict__ dfrag) {
  __shared__ float s_frag[kRows][kBwdBatch];
  __shared__ float s_part[kWarps][kRows][kBwdBatch];

  const int p = threadIdx.x;
  const size_t fs = static_cast<size_t>(f_stride);

  if (blockIdx.x >= n_tiles) {
    const int live = __ldg(tile_start + n_tiles - 1) +
                     __ldg(tile_len + n_tiles - 1);
    const int s0 = (blockIdx.x - n_tiles) * kTailSlots;
    const int s1 = min(s0 + kTailSlots, f_stride);
    for (int s = max(s0, live) + p; s < s1; s += kPix) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) dfrag[r * fs + s] = 0.0f;
    }
    return;
  }

  const int tile = blockIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = static_cast<float>(p % kTile) + 0.5f;
  const float py = static_cast<float>(p / kTile) + 0.5f;
  const int start = __ldg(tile_start + tile);
  const int len = __ldg(tile_len + tile);
  const int drawn = __ldg(draw_len + tile);
  const float ring_lo = ring_lo_of(cutoff_sq);

  const float* o = out + static_cast<size_t>(tile) * 4 * kPix;
  const float* g = g_out + static_cast<size_t>(tile) * 4 * kPix;
  const float g_r = g[0 * kPix + p];
  const float g_g = g[1 * kPix + p];
  const float g_b = g[2 * kPix + p];
  const float t_f = o[3 * kPix + p];
  const float gt_total = g[3 * kPix + p] + (g_r * bg_r + g_g * bg_g +
                                            g_b * bg_b);
  const float cbl_r = o[0 * kPix + p] - t_f * bg_r;
  const float cbl_g = o[1 * kPix + p] - t_f * bg_g;
  const float cbl_b = o[2 * kPix + p] - t_f * bg_b;
  const float g_tail = gt_total * t_f;

  float t = 1.0f;
  float a_r = 0.0f, a_g = 0.0f, a_b = 0.0f;  // inclusive prefix colour
  bool done = false;
  int reduced = drawn;  // slots [start, start + reduced) get gradients

  for (int base = 0; base < drawn; base += kBwdBatch) {
    if (__syncthreads_count(done) == kPix) {
      reduced = base;
      break;
    }
    const int count = min(kBwdBatch, drawn - base);
    if (p < count) {
      const size_t col = static_cast<size_t>(start) + base + p;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s_frag[r][p] = __ldg(frags + r * fs + col);
      }
    }
    __syncthreads();
    for (int i = 0; i < count; ++i) {
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
      bool blends = false;
      float alpha, alpha_raw, g_exp, dx, dy;
      if (!done && frag_alpha(s_frag, i, px, py, cutoff_sq, ring_lo, mode,
                              alpha, alpha_raw, g_exp, dx, dy)) {
        blends = true;
        const float c_r = s_frag[5][i];
        const float c_g = s_frag[6][i];
        const float c_b = s_frag[7][i];
        const float w = alpha * t;
        v[5] = g_r * w;
        v[6] = g_g * w;
        v[7] = g_b * w;
        a_r += w * c_r;
        a_g += w * c_g;
        a_b += w * c_b;
        const float u = g_r * c_r + g_g * c_g + g_b * c_b;
        const float g_s = g_r * (cbl_r - a_r) + g_g * (cbl_g - a_g) +
                          g_b * (cbl_b - a_b);
        const float one_minus = 1.0f - alpha;
        const float dalpha = alpha_raw < kAlphaClamp
                                 ? t * u - (g_s + g_tail) / one_minus
                                 : 0.0f;
        if (mode == 1) {
          v[8] = dalpha;
        } else {
          const float op = s_frag[8][i];
          const float d_q = -0.5f * op * (dalpha * g_exp);
          const float d_qx = d_q * dx;
          const float d_qy = d_q * dy;
          v[0] = -2.0f * (s_frag[2][i] * d_qx + s_frag[3][i] * d_qy);
          v[1] = -2.0f * (s_frag[3][i] * d_qx + s_frag[4][i] * d_qy);
          v[2] = d_qx * dx;
          v[3] = 2.0f * (d_qx * dy);
          v[4] = d_qy * dy;
          v[8] = dalpha * g_exp;
        }
        t *= one_minus;
        if (t <= kTMin) done = true;
      }
      if (__any_sync(kFull, blends)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = warp_sum(v[r]);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) s_part[warp][r][i] = v[r];
      }
    }
    __syncthreads();
    if (p < count) {
      const size_t col = static_cast<size_t>(start) + base + p;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) sum += s_part[k][r][p];
        dfrag[r * fs + col] = sum;
      }
    }
  }

  for (int j = reduced + p; j < len; j += kPix) {
    const size_t col = static_cast<size_t>(start) + j;
#pragma unroll
    for (int r = 0; r < kRows; ++r) dfrag[r * fs + col] = 0.0f;
  }
}

// ------------------------------------------------ K5's first design

constexpr int kFirstThreads = 256;  // K5's first design: 8 rows a block

// K5's first design: warp w of the grid sums row w of the gid column over
// the slots whose key equals it (rows past the live ones hold the
// sentinel n and get zeros), reading grad [9, f] at perm[j].
__global__ void __launch_bounds__(kFirstThreads)
segment_sums_first_kernel(const int* __restrict__ keys,
                          const long long* __restrict__ perm,
                          const float* __restrict__ grad, int f,
                          const int* __restrict__ gid_col, int n_rows, int n,
                          float* __restrict__ out) {
  const int row = (blockIdx.x * kFirstThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warps
  const size_t fs = static_cast<size_t>(f);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  int lo = 0;
  int hi = 0;
  const int gid = __ldg(gid_col + row);
  if (gid < n) {
    lo = gs_lower_bound(keys, f, gid);
    hi = gs_lower_bound(keys, f, gid + 1);
  }
  for (int j = lo + lane; j < hi; j += 32) {
    const size_t src = static_cast<size_t>(__ldg(perm + j));
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += __ldg(grad + r * fs + src);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[r] += __shfl_xor_sync(kFull, acc[r], off);
    }
  }
  if (lane == 0) {
    const size_t ns = static_cast<size_t>(n_rows);
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r * ns + row] = acc[r];
  }
}

// ------------------------------------------------ K7's first design

__global__ void __launch_bounds__(256)
expand_bbox_first_kernel(const int* __restrict__ tab, int n,
                         const int* __restrict__ total_ptr, int cap,
                         int tiles_x, int t_total, int* __restrict__ out) {
  const int s = blockIdx.x * 256 + threadIdx.x;
  if (s >= cap) return;
  const size_t cs = static_cast<size_t>(cap);
  if (s < __ldg(total_ptr)) {
    const int* off = tab + GS_TAB_OFF * n;
    const int g = gs_owner(off, n, s);
    const int rank = s - __ldg(off + g);
    const int span = max(__ldg(tab + GS_TAB_SPAN * n + g), 1);
    const int dy = rank / span;
    const int dx = rank - dy * span;
    out[s] = (__ldg(tab + GS_TAB_Y0 * n + g) + dy) * tiles_x +
             __ldg(tab + GS_TAB_X0 * n + g) + dx;
    out[cs + s] = __ldg(tab + GS_TAB_GID * n + g);
  } else {
    out[s] = t_total;
    out[cs + s] = 0;
  }
}

}  // namespace

// K9 level `level` (0-7, csrc/rasterize_fwd.cuh; 6 is K3) over K3's
// arguments: frags f32 [9, f_stride] tile-sorted, x/y tile-local;
// tile_start, tile_len int32 [n_tiles]; out f32 [n_tiles, 4, 256]; boxes
// uint32 [f_stride], where level 0 writes the box word of each slot it
// stages (the other levels leave it alone). n_tiles > 0: the caller
// launches nothing for an empty grid. An unknown level returns
// cudaErrorInvalidValue.
GS_EXPORT int gs_raster_level(int level, const float* frags, int f_stride,
                              const int* tile_start, const int* tile_len,
                              int n_tiles, float bg_r, float bg_g,
                              float bg_b, float cutoff_sq, int mode,
                              float* out, unsigned* boxes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (level) {
#define GS_RASTER_LEVEL(L)                                                  \
  case L:                                                                   \
    return static_cast<int>(launch_rasterize_fwd<L>(                       \
        frags, f_stride, tile_start, tile_len, n_tiles, bg_r, bg_g, bg_b,  \
        cutoff_sq, mode, out, L == kV0Stage ? boxes : nullptr, s));
    GS_RASTER_LEVEL(kV0Stage)
    GS_RASTER_LEVEL(kV1Cull)
    GS_RASTER_LEVEL(kV2Q)
    GS_RASTER_LEVEL(kV3Alpha)
    GS_RASTER_LEVEL(kV4Trans)
    GS_RASTER_LEVEL(kV5Color)
    GS_RASTER_LEVEL(kV6Full)
    GS_RASTER_LEVEL(kV7NoTrans)
#undef GS_RASTER_LEVEL
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3's first design over K3's arguments (as gs_rasterize_fwd takes them).
GS_EXPORT int gs_rasterize_fwd_first(const float* frags, int f_stride,
                                     const int* tile_start,
                                     const int* tile_len, int n_tiles,
                                     float bg_r, float bg_g, float bg_b,
                                     float cutoff_sq, int mode, float* out,
                                     void* stream) {
  rasterize_fwd_first_kernel<<<n_tiles, kPix, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      frags, f_stride, tile_start, tile_len, bg_r, bg_g, bg_b, cutoff_sq,
      mode, out);
  return static_cast<int>(cudaGetLastError());
}

// K10 level `level` (0-3, csrc/segsum.cuh; 2 is K5) over K5's arguments
// (as gs_segment_sums takes them; grad in key order, grad[:, perm], for
// level 1; grad_t unused by level 3, which may pass null). Level 0 writes
// only grad_t, row_of and the zeroed out. An unknown level returns
// cudaErrorInvalidValue.
GS_EXPORT int gs_segsum_level(int level, const int* keys,
                              const long long* perm, const float* grad, int f,
                              const int* gid_col, int n_rows, int n,
                              float* out, float* grad_t, int* row_of,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (level) {
#define GS_SEGSUM_LEVEL(L)                                                  \
  case segsum::L:                                                           \
    return static_cast<int>(segsum::launch_segment_sums<segsum::L>(        \
        keys, perm, grad, f, gid_col, n_rows, n, out, grad_t, row_of, s));
    GS_SEGSUM_LEVEL(kS0Prep)
    GS_SEGSUM_LEVEL(kS1Scan)
    GS_SEGSUM_LEVEL(kS2Gather)
    GS_SEGSUM_LEVEL(kS2NoStage)
#undef GS_SEGSUM_LEVEL
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5's first design over K5's arguments, without its scratch: keys int32
// [f] ascending; perm int64 [f]; grad f32 [9, f] in slot order; gid_col
// int32 [n_rows] ascending, n past the live rows; out f32 [9, n_rows].
// n_rows > 0.
GS_EXPORT int gs_segment_sums_first(const int* keys, const long long* perm,
                                    const float* grad, int f,
                                    const int* gid_col, int n_rows, int n,
                                    float* out, void* stream) {
  const int rows_per_block = kFirstThreads / 32;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  segment_sums_first_kernel<<<blocks, kFirstThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      keys, perm, grad, f, gid_col, n_rows, n, out);
  return static_cast<int>(cudaGetLastError());
}

// K4's first design over K4's arguments: frags f32 [9, f_stride];
// tile_start, tile_len, draw_len int32 [n_tiles]; out, g_out f32
// [n_tiles, 4, 256]; dfrag f32 [9, f_stride], every slot written.
// n_tiles > 0.
GS_EXPORT int gs_rasterize_bwd_first(const float* frags, int f_stride,
                                     const int* tile_start,
                                     const int* tile_len,
                                     const int* draw_len, int n_tiles,
                                     const float* out, const float* g_out,
                                     float bg_r, float bg_g, float bg_b,
                                     float cutoff_sq, int mode, float* dfrag,
                                     void* stream) {
  const int blocks = n_tiles + (f_stride + kTailSlots - 1) / kTailSlots;
  rasterize_bwd_first_kernel<<<blocks, kPix, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      frags, f_stride, tile_start, tile_len, draw_len, n_tiles, out, g_out,
      bg_r, bg_g, bg_b, cutoff_sq, mode, dfrag);
  return static_cast<int>(cudaGetLastError());
}

// K7's first design over K7's arguments: tab int32 [GS_TAB_ROWS, n] with
// n > 0; total int32 [1]; out int32 [2, cap] (tile, gid). cap > 0.
GS_EXPORT int gs_expand_bbox_first(const int* tab, int n, const int* total,
                                   int cap, int tiles_x, int t_total,
                                   int* out, void* stream) {
  expand_bbox_first_kernel<<<(cap + 255) / 256, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      tab, n, total, cap, tiles_x, t_total, out);
  return static_cast<int>(cudaGetLastError());
}
