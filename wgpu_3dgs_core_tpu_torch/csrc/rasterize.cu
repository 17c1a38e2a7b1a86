// Tile rasterizer for sm_90a: the forward blend (K3) and its backward (K4).
//
// K3 replaces wgpu_3dgs_core_tpu/ops/rasterize.py::_fwd_kernel (launcher
//    rasterize_tiles_fwd, pl.pallas_call at rasterize.py:769).
// K4 replaces wgpu_3dgs_core_tpu/ops/rasterize.py::_bwd_kernel and
//    _bwd_block_body (launcher rasterize_tiles_bwd, pl.pallas_call at
//    rasterize.py:824).
//
// What K3 computes: for each 16x16 tile, the front-to-back blend of the
// tile's depth-ordered fragments [start, start + len) of the tile-sorted
// stream, with the rules of render/reference.py and rasterize.py:149-164:
//   alpha = min(0.99, op * exp(-q/2)), q the conic quadratic form;
//   a fragment is kept iff q <= cutoff^2 and alpha >= 1/255;
//   it blends only while the transmittance before it is > 1e-4;
//   ELLIPSE mode (1) is a flat ring q in [0.64 cutoff^2, cutoff^2].
// Output per tile: RGB + T_final * background, and T_final ([T, 4, 256]).
//
// What K4 computes: from K3's output and its cotangent, the gradient of
// every drawn fragment's 9 stream values (x, y, conic a/b/c, r, g, b,
// opacity), front to back as _bwd_block_body derives it:
//   dL/dc_i     = sum_pix g * w_i,   w_i = alpha_i T_i;
//   dL/dalpha_i = sum_ch g_ch (T_i c_ich - S_ich / (1 - alpha_i))
//                 - gT_total T_final / (1 - alpha_i),
//   S_i = C_blend - A_i (A_i the inclusive prefix colour), and the chain
//   through q to the conic, x and y, and to opacity (rasterize.py:647-683).
// The per-pixel terms are summed over the tile's 256 pixels.
//
// What bounds them on the card: the per-(pixel, fragment) arithmetic (K3:
// one exp and ~20 flops to evaluate a fragment at a pixel, ~9 more to
// blend it; K4: the same evaluation, ~47 flops to differentiate a blend,
// and a 9-value block reduction per fragment) and the serial dependence through T inside each
// pixel. Fragment reads are 36 B each, read once per tile.
//
// Design: one 256-thread block per tile, one pixel per thread. Fragments
// are staged cooperatively through shared memory in batches (one
// coalesced load per attribute row); every thread then walks the batch
// from shared memory, where all lanes read the same address (a
// broadcast). K3 lets a pixel stop once it saturates and the block stop at
// the next batch once every pixel has (__syncthreads_count), so occluded
// fragments of dense tiles are never read. K4 walks the same fragments in
// the same order with the same T recurrence (frag_alpha of blend.cuh is
// shared, so both kernels make the same blend decisions bit for bit). Each
// fragment's 9 per-pixel terms are summed by a warp butterfly (skipped by
// a vote when no lane of the warp blends the fragment), then the 8 warp
// partials through shared memory in a fixed order: the gradients are
// deterministic, with no atomics. Every slot of the stream is written:
// fragments a tile did not draw, or drew after it saturated, and the
// stream's padding get exact zeros. The TPU version's window-pair stream
// reads, flag words, group unroll, log-T carry and triangular-matmul
// cumsums existed only for Mosaic and the MXU and are not carried over.

#include "blend.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = kPix / 32;
constexpr int kBwdBatch = 128;       // K4 fragments staged per batch
constexpr int kTailSlots = 4096;     // K4 padding slots zeroed per block

__global__ void __launch_bounds__(kPix)
rasterize_fwd_kernel(const float* __restrict__ frags, int f_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_len, float bg_r, float bg_g,
                     float bg_b, float cutoff_sq, int mode,
                     float* __restrict__ out) {
  __shared__ float s_frag[kRows][kBatch];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  // Tile-local pixel centre: the stream's x/y rows are tile-local.
  const float px = static_cast<float>(p % kTile) + 0.5f;
  const float py = static_cast<float>(p / kTile) + 0.5f;
  const int start = __ldg(tile_start + tile);
  const int len = __ldg(tile_len + tile);
  const float ring_lo = cutoff_sq * 0.64f;

  float t = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  bool done = false;

  for (int base = 0; base < len; base += kBatch) {
    // Also the barrier that keeps the previous batch alive until every
    // thread has finished reading it.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Blocks [0, n_tiles) each differentiate one tile; the blocks after them
// zero the stream's padding slots [live, f_stride), kTailSlots each.
__global__ void __launch_bounds__(kPix)
rasterize_bwd_kernel(const float* __restrict__ frags, int f_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_len,
                     const int* __restrict__ draw_len, int n_tiles,
                     const float* __restrict__ out,
                     const float* __restrict__ g_out, float bg_r, float bg_g,
                     float bg_b, float cutoff_sq, int mode,
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
  const float ring_lo = cutoff_sq * 0.64f;

  // Per-pixel inputs, as the JAX launcher prepares them
  // (rasterize.py:797-806).
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
    // The barrier that keeps the previous batch's staging and partials
    // alive until they are read; past saturation every gradient is 0.
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
        // The 0.99 clamp kills the gradient of alpha.
        const float dalpha = alpha_raw < kAlphaClamp
                                 ? t * u - (g_s + g_tail) / one_minus
                                 : 0.0f;
        if (mode == 1) {
          v[8] = dalpha;  // flat ring: only opacity takes gradient
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
        t *= one_minus;  // K3's recurrence, in K3's order
        if (t <= kTMin) done = true;
      }
      if (__any_sync(0xffffffffu, blends)) {
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

}  // namespace

// frags: f32 [9, f_stride] tile-sorted stream, x/y tile-local;
// tile_start, tile_len: int32 [n_tiles]; out: f32 [n_tiles, 4, 256].
// n_tiles > 0: the caller launches nothing for an empty grid.
GS_EXPORT int gs_rasterize_fwd(const float* frags, int f_stride,
                               const int* tile_start, const int* tile_len,
                               int n_tiles, float bg_r, float bg_g,
                               float bg_b, float cutoff_sq, int mode,
                               float* out, void* stream) {
  rasterize_fwd_kernel<<<n_tiles, kPix, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      frags, f_stride, tile_start, tile_len, bg_r, bg_g, bg_b, cutoff_sq,
      mode, out);
  return static_cast<int>(cudaGetLastError());
}

// frags: f32 [9, f_stride], the stream K3 read; tile_start, tile_len,
// draw_len: int32 [n_tiles] (the tiles cover the stream's live prefix in
// order; draw_len is what K3 drew); out, g_out: f32 [n_tiles, 4, 256], K3's
// output and its cotangent; dfrag: f32 [9, f_stride], every slot written.
// n_tiles > 0, as above.
GS_EXPORT int gs_rasterize_bwd(const float* frags, int f_stride,
                               const int* tile_start, const int* tile_len,
                               const int* draw_len, int n_tiles,
                               const float* out, const float* g_out,
                               float bg_r, float bg_g, float bg_b,
                               float cutoff_sq, int mode, float* dfrag,
                               void* stream) {
  const int tail = (f_stride + kTailSlots - 1) / kTailSlots;
  rasterize_bwd_kernel<<<n_tiles + tail, kPix, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      frags, f_stride, tile_start, tile_len, draw_len, n_tiles, out, g_out,
      bg_r, bg_g, bg_b, cutoff_sq, mode, dfrag);
  return static_cast<int>(cudaGetLastError());
}
