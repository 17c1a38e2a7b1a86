// Native SPZ quantization codecs.
//
// The reference crate's host-side hot loops are the per-gaussian SPZ
// (de)quantization sweeps (reference: src/gaussian.rs:134-352, SURVEY.md
// §3.2). Here those loops are C++ with the exact same f32 numerics as the
// vectorized numpy path in models/spz.py (Rust `as` cast semantics,
// round-half-away-from-zero), exposed over a plain C ABI for ctypes.
// models/spz.py transparently prefers these for large arrays.
//
// Build: csrc/build.sh (g++ -O3 -shared; OpenMP if available).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline float rust_round(float x) {
    // f32::round: half away from zero.
    return std::truncf(x + std::copysignf(0.5f, x));
}

inline uint8_t cast_u8(float x) {
    // Rust `as u8`: saturate then truncate toward zero.
    if (!(x > 0.0f)) return 0;
    if (x >= 255.0f) return 255;
    return static_cast<uint8_t>(x);
}

inline int32_t cast_i32(float x) {
    if (!(x == x)) return 0;
    if (x <= -2147483648.0f) return INT32_MIN;
    if (x >= 2147483647.0f) return INT32_MAX;
    return static_cast<int32_t>(x);
}

constexpr float FRAC_1_SQRT_2 = 0.70710678118654752440f;
constexpr float SQRT_2 = 1.41421356237309504880f;
constexpr int C_MASK = 511;

// Color rescale constants (reference: src/gaussian.rs:127-131).
constexpr float SH0 = 0.2820948f;
constexpr float SPZ_SH0 = 0.15f;
const float COLOR_A_B = SH0 / SPZ_SH0;
const float COLOR_C = (1.0f - COLOR_A_B) * (0.5f * 255.0f);

}  // namespace

extern "C" {

// ----------------------------------------------------------------- positions

void spz_decode_fixed24(const uint8_t* in, int64_t n, int frac_bits,
                        float* out) {
    const float scale = 1.0f / static_cast<float>(1u << frac_bits);
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n * 3; ++i) {
        const uint8_t* b = in + i * 3;
        int32_t fixed = static_cast<int32_t>(b[0]) |
                        (static_cast<int32_t>(b[1]) << 8) |
                        (static_cast<int32_t>(b[2]) << 16);
        if (fixed & 0x800000) fixed |= static_cast<int32_t>(0xff000000u);
        out[i] = static_cast<float>(fixed) * scale;
    }
}

void spz_encode_fixed24(const float* in, int64_t n, int frac_bits,
                        uint8_t* out) {
    const float scale = static_cast<float>(1u << frac_bits);
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n * 3; ++i) {
        const int32_t fixed = cast_i32(rust_round(in[i] * scale));
        const uint32_t u = static_cast<uint32_t>(fixed);
        uint8_t* b = out + i * 3;
        b[0] = u & 0xff;
        b[1] = (u >> 8) & 0xff;
        b[2] = (u >> 16) & 0xff;
    }
}

// ------------------------------------------------------------------- scales

void spz_decode_scales(const uint8_t* in, int64_t n, float* out) {
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n * 3; ++i) {
        out[i] = std::exp(static_cast<float>(in[i]) / 16.0f - 10.0f);
    }
}

void spz_encode_scales(const float* in, int64_t n, uint8_t* out) {
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n * 3; ++i) {
        const float ln = std::log(in[i]);
        float v = rust_round((ln + 10.0f) * 16.0f);
        if (v < 0.0f) v = 0.0f;
        if (v > 255.0f) v = 255.0f;
        out[i] = cast_u8(v);
    }
}

// ---------------------------------------------------------------- rotations

void spz_decode_quat_first3(const uint8_t* in, int64_t n, float* out) {
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* q = in + i * 3;
        float x = static_cast<float>(q[0]) / 127.5f - 1.0f;
        float y = static_cast<float>(q[1]) / 127.5f - 1.0f;
        float z = static_cast<float>(q[2]) / 127.5f - 1.0f;
        float ww = 1.0f - (x * x + y * y + z * z);
        float w = ww > 0.0f ? std::sqrt(ww) : 0.0f;
        float* o = out + i * 4;
        o[0] = x; o[1] = y; o[2] = z; o[3] = w;
    }
}

void spz_encode_quat_first3(const float* in, int64_t n, uint8_t* out) {
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n; ++i) {
        const float* q = in + i * 4;
        float norm = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                               q[3] * q[3]);
        float x = q[0] / norm, y = q[1] / norm, z = q[2] / norm,
              w = q[3] / norm;
        if (w < 0.0f) { x = -x; y = -y; z = -z; }
        uint8_t* o = out + i * 3;
        const float c[3] = {x, y, z};
        for (int k = 0; k < 3; ++k) {
            float v = rust_round((c[k] + 1.0f) * 127.5f);
            if (v < 0.0f) v = 0.0f;
            if (v > 255.0f) v = 255.0f;
            o[k] = cast_u8(v);
        }
    }
}

// v3 smallest-three. Mirrors the reference exactly, including its
// LSB-read / MSB-write component ordering (reference:
// src/gaussian.rs:166-197 vs 256-287).
void spz_decode_quat_smallest3(const uint8_t* in, int64_t n, float* out) {
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* b = in + i * 4;
        uint32_t comp = static_cast<uint32_t>(b[0]) |
                        (static_cast<uint32_t>(b[1]) << 8) |
                        (static_cast<uint32_t>(b[2]) << 16) |
                        (static_cast<uint32_t>(b[3]) << 24);
        const int largest = comp >> 30;
        float sum_sq = 0.0f;
        float* o = out + i * 4;
        for (int k = 0; k < 4; ++k) {
            if (k == largest) { o[k] = 0.0f; continue; }
            const uint32_t mag = comp & C_MASK;
            const uint32_t neg = (comp >> 9) & 1;
            comp >>= 10;
            float v = FRAC_1_SQRT_2 *
                      (static_cast<float>(mag) / static_cast<float>(C_MASK));
            if (neg) v = -v;
            sum_sq += v * v;
            o[k] = v;
        }
        float rest = 1.0f - sum_sq;
        o[largest] = rest > 0.0f ? std::sqrt(rest) : 0.0f;
    }
}

void spz_encode_quat_smallest3(const float* in, int64_t n, uint8_t* out) {
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n; ++i) {
        const float* q = in + i * 4;
        float norm = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                               q[3] * q[3]);
        float c[4] = {q[0] / norm, q[1] / norm, q[2] / norm, q[3] / norm};
        // Rust max_by keeps the LAST maximum on ties.
        int largest = 0;
        float best = -1.0f;
        for (int k = 0; k < 4; ++k) {
            const float a = std::fabs(c[k]);
            if (a >= best) { best = a; largest = k; }
        }
        const uint32_t negate = c[largest] < 0.0f ? 1u : 0u;
        uint32_t comp = static_cast<uint32_t>(largest);
        for (int k = 0; k < 4; ++k) {
            if (k == largest) continue;
            const uint32_t neg = (c[k] < 0.0f ? 1u : 0u) ^ negate;
            float m = static_cast<float>(C_MASK) * (std::fabs(c[k]) * SQRT_2) +
                      0.5f;
            if (m < 0.0f) m = 0.0f;
            if (m > static_cast<float>(C_MASK - 1))
                m = static_cast<float>(C_MASK - 1);
            comp = (comp << 10) | (neg << 9) | static_cast<uint32_t>(m);
        }
        uint8_t* o = out + i * 4;
        o[0] = comp & 0xff;
        o[1] = (comp >> 8) & 0xff;
        o[2] = (comp >> 16) & 0xff;
        o[3] = (comp >> 24) & 0xff;
    }
}

// ------------------------------------------------------------------- colors

void spz_decode_colors(const uint8_t* in, int64_t n, uint8_t* out) {
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n * 3; ++i) {
        out[i] = cast_u8(static_cast<float>(in[i]) * COLOR_A_B + COLOR_C);
    }
}

void spz_encode_colors(const uint8_t* in, int64_t n, uint8_t* out) {
#pragma omp parallel for if (n > 100000)
    for (int64_t i = 0; i < n * 3; ++i) {
        out[i] = cast_u8((static_cast<float>(in[i]) - COLOR_C) / COLOR_A_B);
    }
}

// ----------------------------------------------------------------------- SH

void spz_decode_sh(const uint8_t* in, int64_t count, float* out) {
#pragma omp parallel for if (count > 1000000)
    for (int64_t i = 0; i < count; ++i) {
        out[i] = (static_cast<float>(in[i]) - 128.0f) / 128.0f;
    }
}

// Bucket quantization (reference: src/gaussian.rs:319-327): bucket only
// when bucket_size < 8.
void spz_encode_sh(const float* in, int64_t count, int bucket,
                   uint8_t* out) {
#pragma omp parallel for if (count > 1000000)
    for (int64_t i = 0; i < count; ++i) {
        float r = rust_round(in[i] * 128.0f + 128.0f);
        uint32_t q = r <= 0.0f ? 0u
                     : (r >= 4294967295.0f ? 4294967295u
                                           : static_cast<uint32_t>(r));
        if (bucket < 8) {
            q = (q + bucket / 2) / bucket * bucket;
        }
        out[i] = q > 255u ? 255 : static_cast<uint8_t>(q);
    }
}

int spz_codec_abi_version(void) { return 1; }

}  // extern "C"
