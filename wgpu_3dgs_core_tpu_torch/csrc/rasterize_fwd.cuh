// K3, the forward tile blend, as one body templated on a level of K9, and
// the staging and cull helpers K4 shares with it (sm_90a).
//
// csrc/rasterize.cu launches the body at kV6Full: that is K3. K9
// (csrc/variants.cu) launches every level from this same source, so its
// full level is K3 compiled again, and each level below it is K3 with
// the ingredients after it taken out. Levels, cumulative:
//   kV0Stage   the batch staging and each fragment's pixel box; each
//              staged box word is also written out (so the card's boxes
//              can be read), and every pixel sums the staged opacities;
//   kV1Cull    the warp's ballot walk over the fragments whose box meets
//              its 8x4 pixel block, summing their opacities;
//   kV2Q       q of each walked (pixel, fragment) pair, summed;
//   kV3Alpha   frag_alpha (exp, clamp, cutoff and 1/255 tests), the kept
//              alphas summed;
//   kV4Trans   the T recurrence while T > 1e-4 (a mask: no stop), no
//              colour: K3's tile for black fragments;
//   kV5Color   the colour, still no stop: K3's tile (the same blends in
//              the same order);
//   kV6Full    the per-pixel stop and the block's __syncthreads_count
//              exit: K3;
//   kV7NoTrans kV6Full with exp(-q/2) replaced by 1 - q/2, arithmetic of
//              the same shape: kV6Full - kV7NoTrans prices the exp.
// Levels 0-3 write their sum in channel 0 and zeros in 1-3; levels 4-7 a
// K3 tile. Every level writes a result that depends on all its work.
// The branches are `if constexpr`, so kV6Full compiles to the kernel K3
// was before the levels shared its source.
#pragma once

#include "blend.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kPix / 32;

enum RasterLevel : int {
  kV0Stage = 0,
  kV1Cull = 1,
  kV2Q = 2,
  kV3Alpha = 3,
  kV4Trans = 4,
  kV5Color = 5,
  kV6Full = 6,
  kV7NoTrans = 7,
};

// Thread p's pixel, row-major in the tile: warp w covers columns
// 8 (w & 1) .. + 7 and rows 4 (w >> 1) .. + 3, lane l the block's pixel
// (l & 7, l >> 3). The output keeps its row-major pixel order.
__device__ __forceinline__ int pixel_of(int p) {
  const int w = p >> 5;
  const int l = p & 31;
  return ((w >> 1) * 4 + (l >> 3)) * kTile + (w & 1) * 8 + (l & 7);
}

// Warp w's pixel block [x0, x1] x [y0, y1].
__device__ __forceinline__ void warp_block(int w, int& x0, int& x1, int& y0,
                                           int& y1) {
  x0 = (w & 1) * 8;
  x1 = x0 + 7;
  y0 = (w >> 1) * 4;
  y1 = y0 + 3;
}

// Stage fragments [col, col + count) of the stream: thread p < count
// loads fragment p's 9 rows (one coalesced load per row) and its pixel
// box.
template <int kCols>
__device__ __forceinline__ void stage_batch(const float* __restrict__ frags,
                                            size_t fs, size_t col, int count,
                                            int p, float cutoff_sq, int mode,
                                            float (*s_frag)[kCols],
                                            unsigned* s_box) {
  if (p >= count) return;
  float f[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    f[r] = __ldg(frags + r * fs + col + p);
    s_frag[r][p] = f[r];
  }
  s_box[p] = frag_pixel_box(f[0], f[1], f[2], f[3], f[4], f[8], cutoff_sq,
                            mode);
}

// The warp's hits among fragments [c, c + 32) of a staged batch: bit j set
// when fragment c + j (< count) has a box meeting the warp's pixel block.
// Warp-uniform.
__device__ __forceinline__ unsigned warp_hits(const unsigned* s_box, int c,
                                              int count, int lane, int x0,
                                              int x1, int y0, int y1) {
  const int j = c + lane;
  return __ballot_sync(kFull,
                       j < count && box_hits(s_box[j], x0, x1, y0, y1));
}

// frag_alpha with the falloff exp(-q/2) replaced by 1 - q/2 (kV7NoTrans).
template <int kCols>
__device__ __forceinline__ bool frag_alpha_notrans(
    float (*f)[kCols], int i, float px, float py, float cutoff_sq,
    float ring_lo, int mode, float& alpha) {
  float dx, dy;
  const float q = frag_q(f, i, px, py, dx, dy);
  const float op = f[8][i];
  bool ok;
  float alpha_raw;
  if (mode == 1) {
    alpha_raw = op;
    ok = (q <= cutoff_sq) && (q >= ring_lo);
  } else {
    alpha_raw = __fmul_rn(op, __fadd_rn(1.0f, __fmul_rn(-0.5f, q)));
    ok = q <= cutoff_sq;
  }
  alpha = fminf(alpha_raw, kAlphaClamp);
  return ok && (alpha >= kAlphaMin);
}

// Blocks [0, n_tiles), one 256-thread block per tile. boxes is written by
// kV0Stage only (a box word per staged slot); the other levels take null.
template <int kLevel>
__global__ void __launch_bounds__(kPix)
rasterize_fwd_kernel(const float* __restrict__ frags, int f_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_len, float bg_r, float bg_g,
                     float bg_b, float cutoff_sq, int mode,
                     float* __restrict__ out, unsigned* __restrict__ boxes) {
  constexpr bool kStop = kLevel >= kV6Full;  // the per-pixel and block exit
  __shared__ float s_frag[kRows][kBatch];
  __shared__ unsigned s_box[kBatch];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int pix = pixel_of(p);
  // Tile-local pixel centre: the stream's x/y rows are tile-local.
  const float px = static_cast<float>(pix % kTile) + 0.5f;
  const float py = static_cast<float>(pix / kTile) + 0.5f;
  int x0, x1, y0, y1;
  warp_block(p >> 5, x0, x1, y0, y1);
  const int start = __ldg(tile_start + tile);
  const int len = __ldg(tile_len + tile);
  const float ring_lo = ring_lo_of(cutoff_sq);
  const size_t fs = static_cast<size_t>(f_stride);

  float t = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;  // levels 0-3: acc_r
  bool done = false;                              // set where kStop

  for (int base = 0; base < len; base += kBatch) {
    // Also the barrier that keeps the previous batch alive until every
    // thread has finished reading it.
    if constexpr (kStop) {
      if (__syncthreads_count(done) == kPix) break;
    } else {
      __syncthreads();
    }
    const int count = min(kBatch, len - base);
    const size_t col = static_cast<size_t>(start) + base;
    stage_batch(frags, fs, col, count, p, cutoff_sq, mode, s_frag, s_box);
    if constexpr (kLevel == kV0Stage) {
      if (p < count) boxes[col + p] = s_box[p];
    }
    __syncthreads();
    if constexpr (kLevel == kV0Stage) {
      for (int i = 0; i < count; ++i) acc_r += s_frag[8][i];
      continue;
    }
    for (int c = 0; c < count; c += 32) {
      unsigned hits = warp_hits(s_box, c, count, lane, x0, x1, y0, y1);
      if (done) continue;
      while (hits) {
        const int i = c + __ffs(hits) - 1;
        hits &= hits - 1;
        if constexpr (kLevel == kV1Cull) {
          acc_r += s_frag[8][i];
          continue;
        }
        if constexpr (kLevel == kV2Q) {
          float dx, dy;
          acc_r += frag_q(s_frag, i, px, py, dx, dy);
          continue;
        }
        float alpha;
        bool keep;
        if constexpr (kLevel == kV7NoTrans) {
          keep = frag_alpha_notrans(s_frag, i, px, py, cutoff_sq, ring_lo,
                                    mode, alpha);
        } else {
          float alpha_raw, g_exp, dx, dy;
          keep = frag_alpha(s_frag, i, px, py, cutoff_sq, ring_lo, mode,
                            alpha, alpha_raw, g_exp, dx, dy);
        }
        if constexpr (kLevel == kV3Alpha) {
          if (keep) acc_r += alpha;
          continue;
        }
        if (!keep) continue;
        if constexpr (!kStop) {
          if (t <= kTMin) continue;  // K3's blend rule, as a mask
        }
        const float w = alpha * t;
        if constexpr (kLevel != kV4Trans) {
          acc_r += w * s_frag[5][i];
          acc_g += w * s_frag[6][i];
          acc_b += w * s_frag[7][i];
        }
        t *= 1.0f - alpha;
        if constexpr (kStop) {
          if (t <= kTMin) {
            done = true;
            break;
          }
        }
      }
    }
  }

  float* o = out + static_cast<size_t>(tile) * 4 * kPix;
  if constexpr (kLevel <= kV3Alpha) {
    o[0 * kPix + pix] = acc_r;
    o[1 * kPix + pix] = 0.0f;
    o[2 * kPix + pix] = 0.0f;
    o[3 * kPix + pix] = 0.0f;
  } else {
    o[0 * kPix + pix] = acc_r + t * bg_r;
    o[1 * kPix + pix] = acc_g + t * bg_g;
    o[2 * kPix + pix] = acc_b + t * bg_b;
    o[3 * kPix + pix] = t;
  }
}

// Level kLevel over n_tiles > 0 tiles on `stream`.
template <int kLevel>
cudaError_t launch_rasterize_fwd(const float* frags, int f_stride,
                                 const int* tile_start, const int* tile_len,
                                 int n_tiles, float bg_r, float bg_g,
                                 float bg_b, float cutoff_sq, int mode,
                                 float* out, unsigned* boxes,
                                 cudaStream_t stream) {
  rasterize_fwd_kernel<kLevel><<<n_tiles, kPix, 0, stream>>>(
      frags, f_stride, tile_start, tile_len, bg_r, bg_g, bg_b, cutoff_sq,
      mode, out, boxes);
  return cudaGetLastError();
}

}  // namespace
