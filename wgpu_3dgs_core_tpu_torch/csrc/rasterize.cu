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
// and a 9-value warp reduction per fragment a warp blends) and the serial
// dependence through T inside each pixel. Fragment reads are 36 B each,
// read once per tile.
//
// Design: one 256-thread block per tile, one pixel
// per thread, each warp on an 8x4 pixel block. Fragments are staged
// cooperatively through shared memory in batches (one coalesced load per
// attribute row), each with its conservative pixel box (blend.cuh's
// frag_pixel_box: the pixels outside it are ones frag_alpha rejects). A
// warp then walks, in order, only the fragments whose box meets its pixels
// (a ballot over each 32 staged boxes): the others it would reject at every
// one of its pixels, so the output is bit for bit the full loop's. All
// lanes read a staged fragment at the same address (a broadcast). K3 lets a
// pixel stop once it saturates and the block stop at the next batch once
// every pixel has (__syncthreads_count), so occluded fragments of dense
// tiles are never read. K4 walks the same fragments in the same order with
// the same T recurrence (frag_alpha of blend.cuh is shared, so both kernels
// make the same blend decisions bit for bit), and a warp stops walking once
// all its pixels have saturated. The 9 per-pixel terms of each fragment a
// warp blends are summed by a reduce-scatter across the warp (12 shuffles,
// where a butterfly per value takes 45), the lanes holding the 9 sums store
// them to shared memory, and the block sums the warps' partials in a fixed
// order, skipping the warps that blended nothing: the gradients are
// deterministic, with no atomics. Every slot of the stream is written:
// fragments a tile did not draw, or drew after it saturated, and the
// stream's padding get exact zeros. The TPU version's window-pair stream
// reads, flag words, group unroll, log-T carry and triangular-matmul
// cumsums existed only for Mosaic and the MXU and are not carried over.
// Each warp covers an 8x4 pixel block rather than two 16-pixel rows: the
// bench scene's boxes are about 9 pixels wide, so a block meets fewer of
// them. Reducing one fragment at a time keeps K4 at 64 registers; three
// at once took 127 and halved the resident blocks (PERF.md). K3's body
// lives in rasterize_fwd.cuh, templated on the levels of K9, which
// compiles the same source for its levels (csrc/variants.cu). The first
// designs of K3 (no cull) and K4 are variants.cu's rasterize_fwd_first_
// kernel and rasterize_bwd_first_kernel, kept as measurement records.

#include "blend.cuh"
#include "common.cuh"
#include "rasterize_fwd.cuh"

namespace {

constexpr int kBwdBatch = 128;       // K4 fragments staged per batch
constexpr int kBwdChunks = kBwdBatch / 32;
constexpr int kTailSlots = 4096;     // K4 padding slots zeroed per block

// A warp's reduce-scatter of its lanes' 9 values: after it, the lane that
// reduce_scatter_row names holds the sum over the 32 lanes of value row.
// Each step over lane bit b (4 down to 0) halves the values a lane keeps,
// the first ceil(s / 2) to the lanes with the bit clear and the rest to
// the others, one shuffle per kept value: 5 + 3 + 2 + 1 + 1 = 12
// shuffles, where a butterfly per value takes 45. The order of the
// additions is fixed.
__device__ __forceinline__ float reduce_scatter(float (&v)[kRows],
                                                int lane) {
  int s = kRows;  // values still held: a constant once the loops unroll
#pragma unroll
  for (int b = 4; b >= 0; --b) {
    const int m = 1 << b;
    if (s > 1) {
      const int ns = (s + 1) / 2;
      const bool upper = (lane & m) != 0;
#pragma unroll
      for (int k = 0; k < (kRows + 1) / 2; ++k) {
        if (k < ns) {
          const float lo = v[k];
          const float hi = ns + k < s ? v[ns + k] : 0.0f;
          const float keep = upper ? hi : lo;
          const float send = upper ? lo : hi;
          v[k] = keep + __shfl_xor_sync(kFull, send, m);
        }
      }
      s = ns;
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], m);
    }
  }
  return v[0];
}

// The value reduce_scatter leaves in `lane`, or -1 where the lane holds
// padding or a copy another lane (with a clear bit) already holds.
__device__ __forceinline__ int reduce_scatter_row(int lane) {
  int s = kRows;
  int off = 0;
  int real = kRows;  // the values among the ones held that are not padding
  for (int b = 4; b >= 0; --b) {
    const bool upper = ((lane >> b) & 1) != 0;
    if (s > 1) {
      const int ns = (s + 1) / 2;
      if (upper) {
        off += ns;
        real = max(real - ns, 0);
      } else {
        real = min(real, ns);
      }
      s = ns;
    } else if (upper) {
      real = 0;
    }
  }
  return real > 0 ? off : -1;
}

// K4: blocks [0, n_tiles) each differentiate one tile; the blocks after
// them zero the stream's padding slots [live, f_stride), kTailSlots each.
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
  __shared__ unsigned s_box[kBwdBatch];
  // A warp's 9 sums of each fragment it wrote, and which it wrote.
  __shared__ float s_part[kWarps][kBwdBatch][kRows];
  __shared__ unsigned s_wrote[kWarps][kBwdChunks];

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
  const int pix = pixel_of(p);
  const float px = static_cast<float>(pix % kTile) + 0.5f;
  const float py = static_cast<float>(pix / kTile) + 0.5f;
  int x0, x1, y0, y1;
  warp_block(warp, x0, x1, y0, y1);
  const int start = __ldg(tile_start + tile);
  const int len = __ldg(tile_len + tile);
  const int drawn = __ldg(draw_len + tile);
  const float ring_lo = ring_lo_of(cutoff_sq);
  const int row = reduce_scatter_row(lane);  // the sum this lane stores

  // Per-pixel inputs, as the JAX launcher prepares them
  // (rasterize.py:797-806).
  const float* o = out + static_cast<size_t>(tile) * 4 * kPix;
  const float* g = g_out + static_cast<size_t>(tile) * 4 * kPix;
  const float g_r = g[0 * kPix + pix];
  const float g_g = g[1 * kPix + pix];
  const float g_b = g[2 * kPix + pix];
  const float t_f = o[3 * kPix + pix];
  const float gt_total = g[3 * kPix + pix] + (g_r * bg_r + g_g * bg_g +
                                              g_b * bg_b);
  const float cbl_r = o[0 * kPix + pix] - t_f * bg_r;
  const float cbl_g = o[1 * kPix + pix] - t_f * bg_g;
  const float cbl_b = o[2 * kPix + pix] - t_f * bg_b;
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
    stage_batch(frags, fs, static_cast<size_t>(start) + base, count, p,
                cutoff_sq, mode, s_frag, s_box);
    __syncthreads();
    for (int c = 0; c < count; c += 32) {
      unsigned hits = warp_hits(s_box, c, count, lane, x0, x1, y0, y1);
      if (__all_sync(kFull, done)) hits = 0;
      unsigned wrote = 0;
      while (hits) {
        const int b = __ffs(hits) - 1;
        hits &= hits - 1;
        const int i = c + b;
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
        if (__any_sync(kFull, blends)) {
          const float sum = reduce_scatter(v, lane);
          if (row >= 0) s_part[warp][i][row] = sum;
          wrote |= 1u << b;
        }
      }
      if (lane == 0) s_wrote[warp][c >> 5] = wrote;
    }
    __syncthreads();
    if (p < count) {
      const size_t col = static_cast<size_t>(start) + base + p;
      unsigned wrote[kWarps];
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        wrote[k] = (s_wrote[k][p >> 5] >> (p & 31)) & 1u;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {
          if (wrote[k]) sum += s_part[k][p][r];
        }
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
  return static_cast<int>(launch_rasterize_fwd<kV6Full>(
      frags, f_stride, tile_start, tile_len, n_tiles, bg_r, bg_g, bg_b,
      cutoff_sq, mode, out, nullptr, static_cast<cudaStream_t>(stream)));
}

// frags: f32 [9, f_stride], the stream K3 read; tile_start, tile_len,
// draw_len: int32 [n_tiles] (the tiles cover the stream's live prefix in
// order; draw_len is what K3 drew); out, g_out: f32 [n_tiles, 4, 256], K3's
// output and its cotangent; dfrag: f32 [9, f_stride], every slot written.
// n_tiles > 0, as above. The grid is the tiles, then the blocks that zero
// the padding slots.
GS_EXPORT int gs_rasterize_bwd(const float* frags, int f_stride,
                               const int* tile_start, const int* tile_len,
                               const int* draw_len, int n_tiles,
                               const float* out, const float* g_out,
                               float bg_r, float bg_g, float bg_b,
                               float cutoff_sq, int mode, float* dfrag,
                               void* stream) {
  const int blocks = n_tiles + (f_stride + kTailSlots - 1) / kTailSlots;
  rasterize_bwd_kernel<<<blocks, kPix, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      frags, f_stride, tile_start, tile_len, draw_len, n_tiles, out, g_out,
      bg_r, bg_g, bg_b, cutoff_sq, mode, dfrag);
  return static_cast<int>(cudaGetLastError());
}
