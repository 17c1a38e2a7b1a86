// Device library of the port: the __device__ counterparts of
// ops/transforms.py and of the buffer's flag accessors, for kernel-bundle
// kernels to call (ops/kernel_bundle.py includes this header in every
// generated bundle source). It plays the part of the reference's WESL
// shader library (src/shader/gaussian.wesl, model_transform.wesl,
// gaussian_transform.wesl) for its compute bundles, and of the JAX
// package's ops/transforms.py inside Pallas kernels.
//
// Every float operation is written with a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), in the order of the torch
// version: nvcc may not contract any of them into an FMA, so each result
// equals the torch version's on the same inputs bit for bit (eager torch
// rounds every elementwise op on its own).
//
// Layout-selected unpacking: a bundle built with .layout_config(layout)
// defines the layout's 7 feature flags (GaussianLayout.features(), the
// reference's wesl_features) as 0/1 macros before this header, and
// GS_LAYOUT. Then gs::sh_t and gs::cov3d_t are the layout's packed types,
// and gs::unpack_sh / gs::unpack_cov3d take the layout's variant, as the
// reference's @if(feature) functions do.
#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

namespace gs {

// Row-major 3x3 and 4x4 matrices: m[row][column].
struct Mat3 {
  float m[3][3];
};
struct Mat4 {
  float m[4][4];
};

// Rotation matrix of a unit quaternion q (xyzw): ops/transforms.py
// quat_rows, element for element (glam Mat3::from_quat).
__device__ inline Mat3 quat_to_mat3(const float* q) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float x2 = __fadd_rn(x, x), y2 = __fadd_rn(y, y),
              z2 = __fadd_rn(z, z);
  const float xx = __fmul_rn(x, x2), xy = __fmul_rn(x, y2),
              xz = __fmul_rn(x, z2);
  const float yy = __fmul_rn(y, y2), yz = __fmul_rn(y, z2),
              zz = __fmul_rn(z, z2);
  const float wx = __fmul_rn(w, x2), wy = __fmul_rn(w, y2),
              wz = __fmul_rn(w, z2);
  Mat3 r;
  r.m[0][0] = __fsub_rn(1.0f, __fadd_rn(yy, zz));
  r.m[0][1] = __fsub_rn(xy, wz);
  r.m[0][2] = __fadd_rn(xz, wy);
  r.m[1][0] = __fadd_rn(xy, wz);
  r.m[1][1] = __fsub_rn(1.0f, __fadd_rn(xx, zz));
  r.m[1][2] = __fsub_rn(yz, wx);
  r.m[2][0] = __fsub_rn(xz, wy);
  r.m[2][1] = __fadd_rn(yz, wx);
  r.m[2][2] = __fsub_rn(1.0f, __fadd_rn(xx, yy));
  return r;
}

// (a0 * b0 + a1 * b1) + a2 * b2, rounded step by step.
__device__ inline float dot3(float a0, float a1, float a2, float b0, float b1,
                             float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// SR = R diag(s) (model_transform.wesl:105-143; ops/transforms.py
// model_scale_rot_mat). Also M of the covariance below.
__device__ inline Mat3 model_scale_rot_mat(const float* q, const float* s) {
  Mat3 m = quat_to_mat3(q);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) m.m[i][j] = __fmul_rn(m.m[i][j], s[j]);
  }
  return m;
}

// (SR)^-1 = diag(1/s) R^T (model_transform.wesl:64-102).
__device__ inline Mat3 model_transform_inv_sr_mat(const float* q,
                                                  const float* s) {
  const Mat3 r = quat_to_mat3(q);
  Mat3 m;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) m.m[i][j] = __fdiv_rn(r.m[j][i], s[i]);
  }
  return m;
}

// TRS model -> world matrix (model_transform.wesl:18-61).
__device__ inline Mat4 model_transform_mat(const float* pos, const float* q,
                                           const float* s) {
  const Mat3 sr = model_scale_rot_mat(q, s);
  Mat4 m;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) m.m[i][j] = sr.m[i][j];
    m.m[i][3] = pos[i];
    m.m[3][i] = 0.0f;
  }
  m.m[3][3] = 1.0f;
  return m;
}

// Homogeneous world point out[4] of the model-space point p: M (p, 1),
// each row summed in index order (model_transform.wesl:13-15).
__device__ inline void model_to_world(const float* pos, const float* q,
                                      const float* s, const float* p,
                                      float* out) {
  const Mat4 m = model_transform_mat(pos, q, s);
  for (int i = 0; i < 4; ++i) {
    out[i] = __fadd_rn(dot3(m.m[i][0], m.m[i][1], m.m[i][2], p[0], p[1], p[2]),
                       m.m[i][3]);
  }
}

// Upper-triangular covariance (xx, xy, xz, yy, yz, zz) of M M^T with
// M = R diag(s) (gaussian.wesl:80-129; ops/transforms.py
// cov3d_from_rot_scale).
__device__ inline void cov3d_from_rot_scale(const float* q, const float* s,
                                            float* sigma6) {
  const Mat3 m = model_scale_rot_mat(q, s);
  const int rows[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
  for (int k = 0; k < 6; ++k) {
    const float* a = m.m[rows[k][0]];
    const float* b = m.m[rows[k][1]];
    sigma6[k] = dot3(a[0], a[1], a[2], b[0], b[1], b[2]);
  }
}

// Packed upper-triangular sigma6 -> symmetric matrix.
__device__ inline Mat3 sigma6_to_mat3(const float* s6) {
  Mat3 m;
  m.m[0][0] = s6[0];
  m.m[0][1] = m.m[1][0] = s6[1];
  m.m[0][2] = m.m[2][0] = s6[2];
  m.m[1][1] = s6[3];
  m.m[1][2] = m.m[2][1] = s6[4];
  m.m[2][2] = s6[5];
  return m;
}

// u8 RGBA -> f32 in [0, 1] (gaussian.wesl:24-26, unpack4x8unorm).
__device__ inline void unpack_color(const uint8_t* c, float* rgba) {
  for (int k = 0; k < 4; ++k) rgba[k] = __fdiv_rn(float(c[k]), 255.0f);
}

// Packed SH -> 45 f32 (15 coefficients x rgb): the four formats of
// gaussian.wesl:29-77. Only the first 45 packed values are read (HALF and
// NORM8 rows carry alignment padding).
__device__ inline void unpack_sh_single(const float* sh, float* out) {
  for (int k = 0; k < 45; ++k) out[k] = sh[k];
}
__device__ inline void unpack_sh_half(const __half* sh, float* out) {
  for (int k = 0; k < 45; ++k) out[k] = __half2float(sh[k]);
}
// snorm: v / 127 floored at -1.
__device__ inline void unpack_sh_norm8(const int8_t* sh, float* out) {
  for (int k = 0; k < 45; ++k) {
    out[k] = fmaxf(__fdiv_rn(float(sh[k]), 127.0f), -1.0f);
  }
}
__device__ inline void unpack_sh_none(float* out) {
  for (int k = 0; k < 45; ++k) out[k] = 0.0f;
}

// Packed cov3d -> sigma6 f32 (gaussian.wesl:80-149): ROT_SCALE recomputes
// sigma from quat (xyzw) + scale; SINGLE copies and HALF casts.
__device__ inline void unpack_cov3d_rot_scale(const float* c, float* out6) {
  cov3d_from_rot_scale(c, c + 4, out6);
}
__device__ inline void unpack_cov3d_single(const float* c, float* out6) {
  for (int k = 0; k < 6; ++k) out6[k] = c[k];
}
__device__ inline void unpack_cov3d_half(const __half* c, float* out6) {
  for (int k = 0; k < 6; ++k) out6[k] = __half2float(c[k]);
}

// GaussianTransform.flags accessors (gaussian_transform.wesl:14-31).
__device__ inline uint32_t gaussian_transform_display_mode(uint32_t flags) {
  return flags & 0xFFu;
}
__device__ inline uint32_t gaussian_transform_sh_deg(uint32_t flags) {
  return (flags >> 8) & 0xFFu;
}
__device__ inline bool gaussian_transform_no_sh0(uint32_t flags) {
  return ((flags >> 16) & 0xFFu) != 0u;
}
__device__ inline float gaussian_transform_max_std_dev(uint32_t flags) {
  return __fmul_rn(__fdiv_rn(float((flags >> 24) & 0xFFu), 255.0f), 3.0f);
}

#ifdef GS_LAYOUT
#if SH_SINGLE
using sh_t = float;
__device__ inline void unpack_sh(const sh_t* sh, float* out) {
  unpack_sh_single(sh, out);
}
#elif SH_HALF
using sh_t = __half;
__device__ inline void unpack_sh(const sh_t* sh, float* out) {
  unpack_sh_half(sh, out);
}
#elif SH_NORM8
using sh_t = int8_t;
__device__ inline void unpack_sh(const sh_t* sh, float* out) {
  unpack_sh_norm8(sh, out);
}
#else  // SH_NONE: the buffer has no SH resource; the result is zeros.
using sh_t = float;
__device__ inline void unpack_sh(const sh_t*, float* out) {
  unpack_sh_none(out);
}
#endif

#if COV3D_ROT_SCALE
using cov3d_t = float;
__device__ inline void unpack_cov3d(const cov3d_t* c, float* out6) {
  unpack_cov3d_rot_scale(c, out6);
}
#elif COV3D_SINGLE
using cov3d_t = float;
__device__ inline void unpack_cov3d(const cov3d_t* c, float* out6) {
  unpack_cov3d_single(c, out6);
}
#else  // COV3D_HALF
using cov3d_t = __half;
__device__ inline void unpack_cov3d(const cov3d_t* c, float* out6) {
  unpack_cov3d_half(c, out6);
}
#endif
#endif  // GS_LAYOUT

}  // namespace gs
