// The blend rules shared by the rasterizer kernels (sm_90a): K3's forward
// and K4's backward (csrc/rasterize.cu) and K9's variant levels
// (csrc/variants.cu), so every one makes the same per-(pixel, fragment)
// decisions bit for bit. The rules are render/reference.py's and
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

// One fragment at one pixel: alpha (clamped), its unclamped value, the
// gaussian falloff exp(-q/2) (1 in ELLIPSE mode) and the pixel deltas.
// Returns whether the fragment is kept there. q is written with the _rn
// intrinsics, so no FMA contraction can make K3 and K4 round it apart.
template <int kCols>
__device__ __forceinline__ bool frag_alpha(float (*f)[kCols], int i,
                                           float px, float py,
                                           float cutoff_sq, float ring_lo,
                                           int mode, float& alpha,
                                           float& alpha_raw, float& g_exp,
                                           float& dx, float& dy) {
  dx = px - f[0][i];
  dy = py - f[1][i];
  const float q = __fadd_rn(
      __fadd_rn(__fmul_rn(f[2][i], __fmul_rn(dx, dx)),
                __fmul_rn(__fmul_rn(2.0f, f[3][i]), __fmul_rn(dx, dy))),
      __fmul_rn(f[4][i], __fmul_rn(dy, dy)));
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
