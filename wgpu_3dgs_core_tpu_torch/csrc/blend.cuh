// The blend rules shared by the rasterizer kernels (sm_90a): K3's forward
// (csrc/rasterize_fwd.cuh, also K9's levels) and K4's backward
// (csrc/rasterize.cu), so every one makes the same per-(pixel, fragment)
// decisions bit for bit; and the conservative pixel box K3 and K4 cull
// with (frag_pixel_box). The rules are render/reference.py's and
// wgpu_3dgs_core_tpu/ops/rasterize.py:149-164's; the stream is f32
// [9, F] rows x y conic_a conic_b conic_c r g b op, x/y tile-local.
#pragma once

#include <cuda_runtime.h>

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block, one per pixel
constexpr int kBatch = 256;          // K3 fragments staged per batch
constexpr int kRows = 9;             // x y conic_a conic_b conic_c r g b op

constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1e-4f;

// ELLIPSE mode's inner ring bound, 0.64 cutoff^2: the product rounded to
// f32 once, as the plain version and the JAX package round it (a Python
// float times 0.64, compared in f32). Rounding 0.64 to f32 first gives a
// bound one f32 step lower at cutoff^2 = 9, which keeps the pixels whose
// q is that step.
__device__ __forceinline__ float ring_lo_of(float cutoff_sq) {
  return __double2float_rn(static_cast<double>(cutoff_sq) * 0.64);
}

// A fragment's conic quadratic form q at a pixel, and the pixel deltas.
// q is written with the _rn intrinsics, so no FMA contraction can make
// K3 and K4 round it apart.
template <int kCols>
__device__ __forceinline__ float frag_q(float (*f)[kCols], int i, float px,
                                        float py, float& dx, float& dy) {
  dx = px - f[0][i];
  dy = py - f[1][i];
  return __fadd_rn(
      __fadd_rn(__fmul_rn(f[2][i], __fmul_rn(dx, dx)),
                __fmul_rn(__fmul_rn(2.0f, f[3][i]), __fmul_rn(dx, dy))),
      __fmul_rn(f[4][i], __fmul_rn(dy, dy)));
}

// One fragment at one pixel: alpha (clamped), its unclamped value, the
// gaussian falloff exp(-q/2) (1 in ELLIPSE mode) and the pixel deltas.
// Returns whether the fragment is kept there.
template <int kCols>
__device__ __forceinline__ bool frag_alpha(float (*f)[kCols], int i,
                                           float px, float py,
                                           float cutoff_sq, float ring_lo,
                                           int mode, float& alpha,
                                           float& alpha_raw, float& g_exp,
                                           float& dx, float& dy) {
  const float q = frag_q(f, i, px, py, dx, dy);
  const float op = f[8][i];
  bool ok;
  if (mode == 1) {
    g_exp = 1.0f;
    alpha_raw = op;
    ok = (q <= cutoff_sq) && (q >= ring_lo);
  } else {
    g_exp = expf(__fmul_rn(-0.5f, q));
    alpha_raw = __fmul_rn(op, g_exp);
    ok = q <= cutoff_sq;
  }
  alpha = fminf(alpha_raw, kAlphaClamp);
  return ok && (alpha >= kAlphaMin);
}

// ------------------------------------------------------- the pixel box

// A fragment's conservative pixel box: the tile-local pixel columns
// [x_lo, x_hi] and rows [y_lo, y_hi], one byte each of a word (x_lo, x_hi,
// y_lo, y_hi from the low byte up), outside which frag_alpha, as rounded
// above, rejects the fragment at every pixel centre. K3 and K4 skip a
// fragment in a warp whose pixels all lie outside it, so their outputs are
// those of the full loop.
//
// Kept implies q <= R, with R = cutoff^2 and, in SPLAT mode, the radius
// at which op exp(-q/2) falls to 1/255, R = min(cutoff^2, 2 ln(255 op)).
// q is a rounded sum of three rounded products, so it errs by up to
// 4u (a dx^2 + 2|b dx dy| + c dy^2), u = 2^-24; over the exact form that
// is at most 2 (ac + b^2) / det times the exact q (the cancellation of a
// thin ellipse at 45 degrees), so the exact q is at most R / (1 - g) with
// g = kBoxGamma * 2 (ac + b^2) / det. The box is that ellipse's bounding
// box, half-extents sqrt(R c / det) and sqrt(R a / det), widened by
// margins that cover the rounding of every step here and of dx = px - x.
// Non-finite values, a conic that is not positive definite or whose g
// passes kBoxGammaMax get the whole tile; a fragment frag_alpha can
// never keep (op below the 1/255 floor) gets the empty box.
// ops/rasterize.py::frag_pixel_box_plain is this function in torch.
constexpr unsigned kBoxFull = 0x0F000F00u;   // [0, 15] x [0, 15]
constexpr unsigned kBoxEmpty = 0x00100010u;  // lo 16 > hi 0
constexpr float kBoxGamma = 5e-7f;     // > 4u: q's error over the sum above
constexpr float kBoxGammaMax = 0.5f;   // past it, the whole tile
constexpr float kBoxRel = 1e-5f;       // relative margin of each bound
constexpr float kBoxAbs = 1e-4f;       // pixels, absolute margin

__device__ __forceinline__ unsigned frag_pixel_box(float x, float y, float a,
                                                   float b, float c,
                                                   float op, float cutoff_sq,
                                                   int mode) {
  if (!(isfinite(x) && isfinite(y) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(op))) {
    return kBoxFull;
  }
  float r;
  if (mode == 1) {
    if (!(op >= kAlphaMin)) return kBoxEmpty;
    r = cutoff_sq;
  } else {
    if (!(op > 0.0f)) return kBoxEmpty;
    const float la = 2.0f * logf(op * 255.0f);
    r = fminf(cutoff_sq, la + kBoxRel * (fabsf(la) + 1.0f));
  }
  if (!(a > 0.0f && c > 0.0f)) return kBoxFull;
  const float ac = a * c;
  const float bb = b * b;
  const float s = ac + bb;
  const float det = (ac - bb) - 4.0f * kBoxGamma * s;
  if (!(det > 0.0f)) return kBoxFull;
  const float g = kBoxGamma * 2.0f * s / det * (1.0f + kBoxRel);
  if (!(g <= kBoxGammaMax)) return kBoxFull;
  if (r < 0.0f) return kBoxEmpty;  // q >= 0 here: no pixel can keep it
  const float rq = r / (1.0f - g) * (1.0f + kBoxRel);
  const float ex = sqrtf(rq * c / det) * (1.0f + kBoxRel);
  const float ey = sqrtf(rq * a / det) * (1.0f + kBoxRel);
  const float mx = kBoxRel * (fabsf(x) + ex) + kBoxAbs;
  const float my = kBoxRel * (fabsf(y) + ey) + kBoxAbs;
  // Column i's centre is i + 0.5.
  const float x_lo = fmaxf(ceilf(x - ex - 0.5f - mx), 0.0f);
  const float x_hi = fminf(floorf(x + ex - 0.5f + mx), 15.0f);
  const float y_lo = fmaxf(ceilf(y - ey - 0.5f - my), 0.0f);
  const float y_hi = fminf(floorf(y + ey - 0.5f + my), 15.0f);
  if (!(x_lo <= x_hi && y_lo <= y_hi)) return kBoxEmpty;
  return static_cast<unsigned>(x_lo) | (static_cast<unsigned>(x_hi) << 8) |
         (static_cast<unsigned>(y_lo) << 16) |
         (static_cast<unsigned>(y_hi) << 24);
}

// Whether a box meets the pixel block [x0, x1] x [y0, y1].
__device__ __forceinline__ bool box_hits(unsigned box, int x0, int x1,
                                         int y0, int y1) {
  return static_cast<int>(box & 0xFFu) <= x1 &&
         static_cast<int>((box >> 8) & 0xFFu) >= x0 &&
         static_cast<int>((box >> 16) & 0xFFu) <= y1 &&
         static_cast<int>(box >> 24) >= y0;
}
