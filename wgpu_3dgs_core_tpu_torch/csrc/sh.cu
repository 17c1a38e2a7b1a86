// K12, the SH colour of every gaussian, forward and backward, for sm_90a.
//
// Replaces no TPU kernel: the JAX package computes the SH colour in jnp
// (wgpu_3dgs_core_tpu/ops/sh.py::gaussian_color over the view directions
// of render/renderer.py), which XLA fuses. Run as PyTorch operations the
// same graph took ~95 operations forward and ~235 backward, and each
// coefficient's select backward filled and added a whole [N, 15, 3]
// gradient; at 6.1M gaussians that was ~42 ms of a training step. These
// two kernels compute it in one pass each.
//
// What they compute (ops/sh.py::sh_color): the unit direction from the
// camera centre c to each gaussian, d = m - c over max(|d|, 1e-12); the
// rest-band SH (bands 1..DEG) of the gaussian's [15, 3] coefficients in
// that direction; plus the base colour (0.5 under no_sh0); clamped at 0.
// The forward takes torch's graph's operations in its order, each rounded
// once (no contraction into FMAs), so it gives the plain version's bits.
// The backward is the closed form of that graph's gradient, recomputed
// from the inputs: the colour's gradient passes where the unclamped colour
// is >= 0, the norm's where |d| >= 1e-12 (torch's rules at both clamps);
// d_sh is written whole, zeros in the rows above DEG, and d_base is zeros
// under no_sh0. Where |d| is exactly 0 torch's graph gives NaN (0 / 0 in
// the square root's backward) and this gives d_dir / 1e-12.
//
// What bounds them on the card: bytes. The forward moves 216 B a gaussian:
// it reads means, base colour (12 B each) and the 180-B SH row, and writes
// rgb (12 B). The backward reads means, base, SH and d_rgb (216 B) and
// writes d_base, d_sh, d_means (204 B): 420 B. At 3.35 TB/s and 6.1M
// gaussians: 0.39 ms and 0.76 ms.
//
// Design: one thread per gaussian for the arithmetic, kThreads a block.
// The 180-B SH rows are not 16-B aligned one by one, but a block's rows
// (23,040 B) are, so the block stages its SH rows through shared memory
// with coalesced float4 loads (scalar on the ragged tail, or where the
// tensor itself is misaligned), and the backward writes its d_sh rows
// back the same way; a thread's row lies at a stride of 45 words, which
// no two lanes of a warp share a bank at. The [N, 3] inputs are read
// through their strides (a column-major d_rgb, a [N, 4] colour's first
// three columns) without a copy. No atomics: the result is deterministic.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCoef = 45;  // 15 coefficients x 3 channels a gaussian
constexpr int kTile = kThreads * kCoef;  // floats a block stages

// The SH constants as torch's float32 arithmetic rounds them (ops/sh.py).
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kC20 = static_cast<float>(1.0925484305920792);
constexpr float kC21 = static_cast<float>(-1.0925484305920792);
constexpr float kC22 = static_cast<float>(0.31539156525252005);
constexpr float kC23 = static_cast<float>(-1.0925484305920792);
constexpr float kC24 = static_cast<float>(0.5462742152960396);
constexpr float kC30 = static_cast<float>(-0.5900435899266435);
constexpr float kC31 = static_cast<float>(2.890611442640554);
constexpr float kC32 = static_cast<float>(-0.4570457994644658);
constexpr float kC33 = static_cast<float>(0.3731763325901154);
constexpr float kC34 = static_cast<float>(-0.4570457994644658);
constexpr float kC35 = static_cast<float>(1.445305721320277);
constexpr float kC36 = static_cast<float>(-0.5900435899266435);
constexpr float kNormEps = static_cast<float>(1e-12);

// One rounding each, never contracted: the forward's bits are torch's.
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fadd_rn(a, -b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// Copy `count` floats from device memory at `src` to the shared `dst`
// (16-B aligned): float4 loads where `src` is 16-B aligned, then the tail.
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         float* dst, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += kThreads) d4[i] = __ldg(s4 + i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) {
    dst[i] = __ldg(src + i);
  }
}

// The reverse of stage_in: shared `src` to device memory at `dst`.
__device__ __forceinline__ void stage_out(const float* src,
                                          float* __restrict__ dst,
                                          int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += kThreads) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

// The view direction of render/reference.py::view_dirs, op for op.
struct Dir {
  float x, y, z;  // unit direction
  float norm;     // |d|, before the clamp
};

__device__ __forceinline__ Dir view_dir(const float* __restrict__ m,
                                        long long s1, float cx, float cy,
                                        float cz) {
  const float dx = sub(__ldg(m), cx);
  const float dy = sub(__ldg(m + s1), cy);
  const float dz = sub(__ldg(m + 2 * s1), cz);
  const float norm = __fsqrt_rn(add(add(mul(dx, dx), mul(dy, dy)),
                                    mul(dz, dz)));
  const float nc = norm < kNormEps ? kNormEps : norm;
  return {__fdiv_rn(dx, nc), __fdiv_rn(dy, nc), __fdiv_rn(dz, nc), norm};
}

// The unclamped colour of ops/sh.py::gaussian_color, channel by channel,
// with torch's order of operations. `s`: the gaussian's 45 coefficients.
template <int DEG>
__device__ __forceinline__ void color_pre(const float* s, const Dir& v,
                                          const float base[3],
                                          float out[3]) {
  const float x = v.x, y = v.y, z = v.z;
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
  float f[15];  // the per-gaussian factors of bands 2 and 3
  if (DEG >= 2) {
    f[3] = mul(kC20, xy);
    f[4] = mul(kC21, yz);
    f[5] = mul(kC22, sub(sub(mul(2.0f, zz), xx), yy));
    f[6] = mul(kC23, xz);
    f[7] = mul(kC24, sub(xx, yy));
  }
  if (DEG >= 3) {
    f[8] = mul(mul(kC30, y), sub(mul(3.0f, xx), yy));
    f[9] = mul(mul(kC31, xy), z);
    f[10] = mul(mul(kC32, y), sub(sub(mul(4.0f, zz), xx), yy));
    f[11] = mul(mul(kC33, z),
                sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
    f[12] = mul(mul(kC34, x), sub(sub(mul(4.0f, zz), xx), yy));
    f[13] = mul(mul(kC35, z), sub(xx, yy));
    f[14] = mul(mul(kC36, x), sub(xx, mul(3.0f, yy)));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float r = mul(kC1, sub(add(mul(-y, s[c]), mul(z, s[3 + c])),
                           mul(x, s[6 + c])));
    if (DEG >= 2) {
      float t = mul(f[3], s[9 + c]);
#pragma unroll
      for (int k = 4; k < 8; ++k) t = add(t, mul(f[k], s[3 * k + c]));
      r = add(r, t);
    }
    if (DEG >= 3) {
      float t = mul(f[8], s[24 + c]);
#pragma unroll
      for (int k = 9; k < 15; ++k) t = add(t, mul(f[k], s[3 * k + c]));
      r = add(r, t);
    }
    out[c] = add(base[c], r);
  }
}

__device__ __forceinline__ void load_base(const float* __restrict__ b,
                                          long long s1, int no_sh0,
                                          float base[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) base[c] = no_sh0 ? 0.5f : __ldg(b + c * s1);
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
sh_color_fwd_kernel(const float* __restrict__ means, long long m_s0,
                    long long m_s1, const float* __restrict__ base,
                    long long b_s0, long long b_s1,
                    const float* __restrict__ sh, int n, float cx, float cy,
                    float cz, int no_sh0, float* __restrict__ rgb) {
  __shared__ float4 tile4[kTile / 4];
  float* tile = reinterpret_cast<float*>(tile4);
  const long long g0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kThreads),
                                        n - g0));
  stage_in(sh + g0 * kCoef, tile, rows * kCoef);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows) return;
  const long long g = g0 + t;
  const Dir v = view_dir(means + g * m_s0, m_s1, cx, cy, cz);
  float b[3], pre[3];
  load_base(base + g * b_s0, b_s1, no_sh0, b);
  color_pre<DEG>(tile + t * kCoef, v, b, pre);
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[g * 3 + c] = pre[c] < 0.0f ? 0.0f : pre[c];
}

template <int DEG>
__global__ void __launch_bounds__(kThreads)
sh_color_bwd_kernel(const float* __restrict__ means, long long m_s0,
                    long long m_s1, const float* __restrict__ base,
                    long long b_s0, long long b_s1,
                    const float* __restrict__ sh,
                    const float* __restrict__ d_rgb, long long g_s0,
                    long long g_s1, int n, float cx, float cy, float cz,
                    int no_sh0, float* __restrict__ d_base,
                    float* __restrict__ d_sh,
                    float* __restrict__ d_means) {
  constexpr int kUsed = (DEG + 1) * (DEG + 1) - 1;  // coefficients used
  __shared__ float4 tile4[kTile / 4];
  float* tile = reinterpret_cast<float*>(tile4);
  const long long g0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(min(static_cast<long long>(kThreads),
                                        n - g0));
  stage_in(sh + g0 * kCoef, tile, rows * kCoef);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const long long g = g0 + t;
    const Dir v = view_dir(means + g * m_s0, m_s1, cx, cy, cz);
    float* s = tile + t * kCoef;
    float b[3], pre[3], gm[3];
    load_base(base + g * b_s0, b_s1, no_sh0, b);
    color_pre<DEG>(s, v, b, pre);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gc = __ldg(d_rgb + g * g_s0 + c * g_s1);
      gm[c] = pre[c] >= 0.0f ? gc : 0.0f;
      d_base[g * 3 + c] = no_sh0 ? 0.0f : gm[c];
    }
    const float x = v.x, y = v.y, z = v.z;
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    // basis[k]: coefficient k's basis function; grad[k]: its gradient in
    // the direction.
    float basis[15], gx[15], gy[15], gz[15];
    basis[0] = -kC1 * y, gx[0] = 0.0f, gy[0] = -kC1, gz[0] = 0.0f;
    basis[1] = kC1 * z, gx[1] = 0.0f, gy[1] = 0.0f, gz[1] = kC1;
    basis[2] = -kC1 * x, gx[2] = -kC1, gy[2] = 0.0f, gz[2] = 0.0f;
    if (DEG >= 2) {
      basis[3] = kC20 * xy, gx[3] = kC20 * y, gy[3] = kC20 * x, gz[3] = 0.0f;
      basis[4] = kC21 * yz, gx[4] = 0.0f, gy[4] = kC21 * z, gz[4] = kC21 * y;
      basis[5] = kC22 * (2.0f * zz - xx - yy), gx[5] = -2.0f * kC22 * x,
      gy[5] = -2.0f * kC22 * y, gz[5] = 4.0f * kC22 * z;
      basis[6] = kC23 * xz, gx[6] = kC23 * z, gy[6] = 0.0f, gz[6] = kC23 * x;
      basis[7] = kC24 * (xx - yy), gx[7] = 2.0f * kC24 * x,
      gy[7] = -2.0f * kC24 * y, gz[7] = 0.0f;
    }
    if (DEG >= 3) {
      basis[8] = kC30 * y * (3.0f * xx - yy), gx[8] = kC30 * 6.0f * xy,
      gy[8] = kC30 * 3.0f * (xx - yy), gz[8] = 0.0f;
      basis[9] = kC31 * xy * z, gx[9] = kC31 * yz, gy[9] = kC31 * xz,
      gz[9] = kC31 * xy;
      basis[10] = kC32 * y * (4.0f * zz - xx - yy),
      gx[10] = kC32 * -2.0f * xy, gy[10] = kC32 * (4.0f * zz - xx - 3.0f * yy),
      gz[10] = kC32 * 8.0f * yz;
      basis[11] = kC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy),
      gx[11] = kC33 * -6.0f * xz, gy[11] = kC33 * -6.0f * yz,
      gz[11] = kC33 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      basis[12] = kC34 * x * (4.0f * zz - xx - yy),
      gx[12] = kC34 * (4.0f * zz - 3.0f * xx - yy), gy[12] = kC34 * -2.0f * xy,
      gz[12] = kC34 * 8.0f * xz;
      basis[13] = kC35 * z * (xx - yy), gx[13] = kC35 * 2.0f * xz,
      gy[13] = kC35 * -2.0f * yz, gz[13] = kC35 * (xx - yy);
      basis[14] = kC36 * x * (xx - 3.0f * yy),
      gx[14] = kC36 * 3.0f * (xx - yy), gy[14] = kC36 * -6.0f * xy,
      gz[14] = 0.0f;
    }
    // The direction's gradient, and d_sh written over the staged row.
    float ddx = 0.0f, ddy = 0.0f, ddz = 0.0f;
#pragma unroll
    for (int k = 0; k < 15; ++k) {
      if (k < kUsed) {
        const float w = s[3 * k] * gm[0] + s[3 * k + 1] * gm[1]
                        + s[3 * k + 2] * gm[2];
        ddx += w * gx[k];
        ddy += w * gy[k];
        ddz += w * gz[k];
#pragma unroll
        for (int c = 0; c < 3; ++c) s[3 * k + c] = basis[k] * gm[c];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) s[3 * k + c] = 0.0f;
      }
    }
    // Through the normalisation: the norm's gradient passes where
    // |d| >= 1e-12, where the clamped norm is |d| itself.
    const float nc = v.norm < kNormEps ? kNormEps : v.norm;
    if (v.norm >= kNormEps) {
      const float dot = ddx * x + ddy * y + ddz * z;
      ddx -= dot * x;
      ddy -= dot * y;
      ddz -= dot * z;
    }
    d_means[g * 3] = ddx / nc;
    d_means[g * 3 + 1] = ddy / nc;
    d_means[g * 3 + 2] = ddz / nc;
  }
  __syncthreads();
  stage_out(tile, d_sh + g0 * kCoef, rows * kCoef);
}

inline int blocks_of(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// means, base: f32 [n, 3] at element strides (s0, s1) (base unread under
// no_sh0); sh: f32 [n, 15, 3] contiguous; (cx, cy, cz): the camera
// centre; rgb: f32 [n, 3] contiguous. deg >= 1 (3 and above take bands
// 1..3). n > 0: the caller launches nothing for no gaussians.
GS_EXPORT int gs_sh_color_fwd(const float* means, long long m_s0,
                              long long m_s1, const float* base,
                              long long b_s0, long long b_s1, const float* sh,
                              int n, int deg, float cx, float cy, float cz,
                              int no_sh0, float* rgb, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_of(n);
  if (deg == 1) {
    sh_color_fwd_kernel<1><<<blocks, kThreads, 0, st>>>(
        means, m_s0, m_s1, base, b_s0, b_s1, sh, n, cx, cy, cz, no_sh0, rgb);
  } else if (deg == 2) {
    sh_color_fwd_kernel<2><<<blocks, kThreads, 0, st>>>(
        means, m_s0, m_s1, base, b_s0, b_s1, sh, n, cx, cy, cz, no_sh0, rgb);
  } else {
    sh_color_fwd_kernel<3><<<blocks, kThreads, 0, st>>>(
        means, m_s0, m_s1, base, b_s0, b_s1, sh, n, cx, cy, cz, no_sh0, rgb);
  }
  return static_cast<int>(cudaGetLastError());
}

// As gs_sh_color_fwd, plus d_rgb: f32 [n, 3] at strides (g_s0, g_s1);
// outputs d_base, d_means f32 [n, 3] and d_sh f32 [n, 15, 3], contiguous,
// every element written.
GS_EXPORT int gs_sh_color_bwd(const float* means, long long m_s0,
                              long long m_s1, const float* base,
                              long long b_s0, long long b_s1, const float* sh,
                              const float* d_rgb, long long g_s0,
                              long long g_s1, int n, int deg, float cx,
                              float cy, float cz, int no_sh0, float* d_base,
                              float* d_sh, float* d_means, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_of(n);
  if (deg == 1) {
    sh_color_bwd_kernel<1><<<blocks, kThreads, 0, st>>>(
        means, m_s0, m_s1, base, b_s0, b_s1, sh, d_rgb, g_s0, g_s1, n, cx, cy,
        cz, no_sh0, d_base, d_sh, d_means);
  } else if (deg == 2) {
    sh_color_bwd_kernel<2><<<blocks, kThreads, 0, st>>>(
        means, m_s0, m_s1, base, b_s0, b_s1, sh, d_rgb, g_s0, g_s1, n, cx, cy,
        cz, no_sh0, d_base, d_sh, d_means);
  } else {
    sh_color_bwd_kernel<3><<<blocks, kThreads, 0, st>>>(
        means, m_s0, m_s1, base, b_s0, b_s1, sh, d_rgb, g_s0, g_s1, n, cx, cy,
        cz, no_sh0, d_base, d_sh, d_means);
  }
  return static_cast<int>(cudaGetLastError());
}
