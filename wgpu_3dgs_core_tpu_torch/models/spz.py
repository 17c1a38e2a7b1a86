"""SPZ source format: Niantic's gzip-compressed, quantized gaussian format.

A copy of ``wgpu_3dgs_core_tpu.models.spz``, kept equal to it: the port
carries its own numpy layers because importing any submodule of the JAX
package imports jax. Its native codec is the port's own build of
``csrc/spz_codec.cpp`` (utils/native.py).

TPU-native redesign of the reference's SPZ layer (reference:
src/source_format/spz.rs). The file is gzip-wrapped (spz.rs:945-959), with a
16-byte header (spz.rs:436-446) followed by columnar arrays in file order
positions → alphas → colors → scales → rotations → SHs (spz.rs:739-771).

The reference models per-field encodings as Rust enums generated by a macro
(spz.rs:14-208); here each field is simply a numpy array whose shape/dtype is
determined by the header version and SH degree, and the mixed-variant
validation becomes shape validation. All quantization codecs are vectorized
f32 numpy mirroring the reference's per-element Rust math bit-for-bit
(see utils/numeric.py for the Rust cast/round semantics).
"""

from __future__ import annotations

import gzip
import io
import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional, Union

import numpy as np

from ..errors import (
    SpzCountMismatchError,
    SpzEmptyIteratorError,
    SpzInvalidMixedVariantError,
    SpzPositionFloat16MismatchError,
    SpzRotationQuatSmallestThreeMismatchError,
    SpzShDegreeMismatchError,
)
from ..utils import native as _native
from ..utils.numeric import (
    F32,
    cast_u8,
    f16_bits_to_f32,
    f32,
    f32_to_f16_bits,
    normalize_rows,
    rust_round,
)

MAGIC = 0x5053474E  # "NGSP" (reference: spz.rs:458)
SUPPORTED_VERSIONS = range(1, 4)  # 1..=3 (reference: spz.rs:461)
SUPPORTED_SH_DEGREES = range(0, 4)  # 0..=3 (reference: spz.rs:464)

# SH degree -> number of per-channel coefficients (reference: spz.rs:337-345).
SH_DEGREE_TO_NUM_COEFFS = {0: 0, 1: 3, 2: 8, 3: 15}
NUM_COEFFS_TO_SH_DEGREE = {v: k for k, v in SH_DEGREE_TO_NUM_COEFFS.items()}

_HEADER_STRUCT = struct.Struct("<IIIBBBB")  # 16 bytes (reference: spz.rs:438-446)


def validate_sh_degree(sh_degree: int) -> int:
    if sh_degree not in SUPPORTED_SH_DEGREES:
        raise ValueError(f"invalid SPZ SH degree: {sh_degree}, expected 0..=3")
    return sh_degree


@dataclass(frozen=True)
class SpzHeader:
    """Validated SPZ header (reference: spz.rs:448-578)."""

    version: int
    num_points: int
    sh_degree: int
    fractional_bits: int
    antialiased: bool = False

    def __post_init__(self):
        if self.version not in SUPPORTED_VERSIONS:
            raise IOError(
                f"Unsupported SPZ version: {self.version}, expected one of 1..=3"
            )
        validate_sh_degree(self.sh_degree)

    @classmethod
    def default(cls, num_points: int) -> "SpzHeader":
        # Latest version, SH degree 3, 12 fractional bits (reference: spz.rs:515-525).
        return cls(version=3, num_points=num_points, sh_degree=3,
                   fractional_bits=12, antialiased=False)

    @property
    def uses_float16(self) -> bool:
        return self.version == 1  # reference: spz.rs:570-572

    @property
    def uses_quat_smallest_three(self) -> bool:
        return self.version >= 3  # reference: spz.rs:575-577

    @property
    def sh_num_coefficients(self) -> int:
        return SH_DEGREE_TO_NUM_COEFFS[self.sh_degree]

    def to_bytes(self) -> bytes:
        return _HEADER_STRUCT.pack(
            MAGIC,
            self.version,
            self.num_points,
            self.sh_degree,
            self.fractional_bits,
            0x1 if self.antialiased else 0x0,
            0,
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> "SpzHeader":
        magic, version, num_points, sh_degree, frac_bits, flags, _ = (
            _HEADER_STRUCT.unpack(raw)
        )
        if magic != MAGIC:
            # Mirrors the reference's message format (spz.rs:489-498).
            raise IOError(
                f"Invalid SPZ magic number: {magic:X}, expected {MAGIC:X}"
            )
        return cls(
            version=version,
            num_points=num_points,
            sh_degree=sh_degree,
            fractional_bits=frac_bits,
            antialiased=(flags & 0x1) != 0,
        )


@dataclass(frozen=True)
class SpzEncodeOptions:
    """Options for encoding gaussians to SPZ
    (reference: SpzGaussiansFromGaussianSliceOptions, spz.rs:967-1000)."""

    version: int = 3
    sh_degree: int = 3
    fractional_bits: int = 12
    antialiased: bool = False
    # Quantization bits per SH band 1..3 (reference: gaussian.rs:386-392).
    sh_quantize_bits: tuple[int, int, int] = (5, 4, 4)


# ---------------------------------------------------------------------------
# Vectorized codecs (quantized bytes <-> canonical f32 values)
# ---------------------------------------------------------------------------


def decode_positions(positions: np.ndarray, header: SpzHeader) -> np.ndarray:
    """Quantized positions -> f32[N,3] (reference: src/gaussian.rs:135-156)."""
    if header.uses_float16:
        return f16_bits_to_f32(positions)
    n = positions.shape[0]
    lib = _native.get_lib() if n >= _native.MIN_NATIVE_N else None
    if lib is not None:
        out = np.empty((n, 3), np.float32)
        lib.spz_decode_fixed24(
            np.ascontiguousarray(positions, np.uint8), n,
            header.fractional_bits, out,
        )
        return out
    b = positions.astype(np.int32)  # u8[N,3,3] bytes, little-endian 24-bit
    fixed = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    fixed = np.where(fixed & 0x800000, fixed | np.int32(-16777216), fixed)
    scale = F32(1.0) / F32(1 << header.fractional_bits)
    return (fixed.astype(np.float32) * scale).astype(np.float32)


def encode_positions(pos: np.ndarray, header: SpzHeader) -> np.ndarray:
    """f32[N,3] -> quantized positions (reference: src/gaussian.rs:232-249)."""
    pos = f32(pos)
    if header.uses_float16:
        return f32_to_f16_bits(pos)
    n = pos.shape[0]
    lib = _native.get_lib() if n >= _native.MIN_NATIVE_N else None
    if lib is not None:
        out = np.empty((n, 3, 3), np.uint8)
        lib.spz_encode_fixed24(
            np.ascontiguousarray(pos, np.float32), n,
            header.fractional_bits, out,
        )
        return out
    scale = F32(1 << header.fractional_bits)
    fixed = rust_round(pos * scale)
    fixed = np.clip(fixed, -(2.0**31), 2.0**31 - 1).astype(np.int64).astype(np.int32)
    u = fixed.view(np.uint32)
    out = np.empty(pos.shape + (3,), dtype=np.uint8)
    out[..., 0] = (u & 0xFF).astype(np.uint8)
    out[..., 1] = ((u >> 8) & 0xFF).astype(np.uint8)
    out[..., 2] = ((u >> 16) & 0xFF).astype(np.uint8)
    return out


def decode_scales(scales: np.ndarray) -> np.ndarray:
    """u8[N,3] -> linear scales (reference: src/gaussian.rs:158)."""
    n = scales.shape[0]
    lib = _native.get_lib() if n >= _native.MIN_NATIVE_N else None
    if lib is not None:
        out = np.empty((n, 3), np.float32)
        lib.spz_decode_scales(np.ascontiguousarray(scales, np.uint8), n, out)
        return out
    return np.exp(scales.astype(np.float32) / F32(16.0) - F32(10.0)).astype(np.float32)


def encode_scales(scale: np.ndarray) -> np.ndarray:
    """Linear scales -> u8[N,3] (reference: src/gaussian.rs:251-254)."""
    n = scale.shape[0]
    lib = _native.get_lib() if n >= _native.MIN_NATIVE_N else None
    if lib is not None:
        out = np.empty((n, 3), np.uint8)
        lib.spz_encode_scales(np.ascontiguousarray(scale, np.float32), n, out)
        return out
    with np.errstate(divide="ignore"):
        ln = np.log(f32(scale)).astype(np.float32)
    return cast_u8(np.clip(rust_round((ln + F32(10.0)) * F32(16.0)), 0.0, 255.0))


# Ascending non-largest component indices per largest index (v3 codec).
_SMALLEST3_SLOTS = np.array(
    [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64
)
_FRAC_1_SQRT_2 = F32(1.0 / np.sqrt(2.0))
_SQRT_2 = F32(np.sqrt(2.0))
_C_MASK = 511  # (1 << 9) - 1


def decode_rotations(rotations: np.ndarray, header: SpzHeader) -> np.ndarray:
    """Quantized rotations -> f32[N,4] quats in xyzw (reference:
    src/gaussian.rs:160-197).

    v3 note: the reference reads the three packed components from the LSB up
    while assigning to component indices in ascending order, whereas its
    writer places the first (lowest-index) component in the highest bits —
    we mirror both sides exactly (gaussian.rs:176-191 vs 270-279).
    """
    n = rotations.shape[0]
    lib = _native.get_lib() if n >= _native.MIN_NATIVE_N else None
    if lib is not None:
        out = np.empty((n, 4), np.float32)
        rot = np.ascontiguousarray(rotations, np.uint8)
        if header.uses_quat_smallest_three:
            lib.spz_decode_quat_smallest3(rot, n, out)
        else:
            lib.spz_decode_quat_first3(rot, n, out)
        return out
    if not header.uses_quat_smallest_three:
        xyz = rotations.astype(np.float32) / F32(127.5) - F32(1.0)
        w = np.sqrt(np.maximum(
            F32(1.0) - np.sum(xyz * xyz, axis=-1, dtype=np.float32), F32(0.0)
        )).astype(np.float32)
        return np.concatenate([xyz, w[:, None]], axis=-1).astype(np.float32)

    b = rotations.astype(np.uint32)  # u8[N,4]
    comp = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    largest = (comp >> 30).astype(np.int64)

    quat = np.zeros((n, 4), dtype=np.float32)
    sum_squares = np.zeros(n, dtype=np.float32)
    slots = _SMALLEST3_SLOTS[largest]  # [N, 3] ascending non-largest indices
    rows = np.arange(n)
    for k in range(3):
        mag = (comp & _C_MASK).astype(np.float32)
        neg = ((comp >> 9) & 1).astype(np.float32)
        comp = comp >> 10
        value = (_FRAC_1_SQRT_2 * (mag / F32(_C_MASK))
                 * np.where(neg != 0, F32(-1.0), F32(1.0))).astype(np.float32)
        sum_squares += value * value
        quat[rows, slots[:, k]] = value
    quat[rows, largest] = np.sqrt(
        np.maximum(F32(1.0) - sum_squares, F32(0.0))
    ).astype(np.float32)
    return quat


def encode_rotations(rot: np.ndarray, header: SpzHeader) -> np.ndarray:
    """f32[N,4] quats (xyzw) -> quantized rotations (reference:
    src/gaussian.rs:256-296)."""
    n = rot.shape[0]
    lib = _native.get_lib() if n >= _native.MIN_NATIVE_N else None
    if lib is not None:
        rot_c = np.ascontiguousarray(rot, np.float32)
        if header.uses_quat_smallest_three:
            out = np.empty((n, 4), np.uint8)
            lib.spz_encode_quat_smallest3(rot_c, n, out)
        else:
            out = np.empty((n, 3), np.uint8)
            lib.spz_encode_quat_first3(rot_c, n, out)
        return out
    q = normalize_rows(rot)
    if not header.uses_quat_smallest_three:
        # Canonicalize sign on w, pack xyz (gaussian.rs:289-295).
        q = np.where(q[:, 3:4] < 0, -q, q)
        return cast_u8(
            np.clip(rust_round((q[:, 0:3] + F32(1.0)) * F32(127.5)), 0.0, 255.0)
        )

    absq = np.abs(q)
    # Rust max_by returns the LAST maximum on ties (gaussian.rs:258-264).
    largest = (3 - np.argmax(absq[:, ::-1], axis=1)).astype(np.int64)
    rows = np.arange(n)
    negate = q[rows, largest] < 0.0

    comp = largest.astype(np.uint32)
    slots = _SMALLEST3_SLOTS[largest]
    for k in range(3):
        value = q[rows, slots[:, k]]
        neg_bit = ((value < 0.0) ^ negate).astype(np.uint32)
        mag_f = np.clip(
            F32(_C_MASK) * (np.abs(value) * _SQRT_2) + F32(0.5),
            0.0,
            F32(_C_MASK - 1),
        )
        mag = np.trunc(mag_f).astype(np.uint32)
        comp = (comp << np.uint32(10)) | (neg_bit << np.uint32(9)) | mag

    out = np.empty((n, 4), dtype=np.uint8)
    out[:, 0] = (comp & 0xFF).astype(np.uint8)
    out[:, 1] = ((comp >> 8) & 0xFF).astype(np.uint8)
    out[:, 2] = ((comp >> 16) & 0xFF).astype(np.uint8)
    out[:, 3] = ((comp >> 24) & 0xFF).astype(np.uint8)
    return out


# SPZ stores colors on a 0.15 SH0 scale vs the IR's 0.2820948
# (reference: src/gaussian.rs:127-131).
SH0_TO_LINEAR_FACTOR = F32(0.2820948)
SPZ_SH0_TO_LINEAR_FACTOR = F32(0.15)
_COLOR_FRAC_A_B = F32(SH0_TO_LINEAR_FACTOR / SPZ_SH0_TO_LINEAR_FACTOR)
_COLOR_C = F32((F32(1.0) - _COLOR_FRAC_A_B) * F32(0.5 * 255.0))


def decode_colors(colors: np.ndarray) -> np.ndarray:
    """SPZ u8 colors -> IR u8 colors (reference: src/gaussian.rs:199-203)."""
    n = colors.shape[0]
    lib = _native.get_lib() if n >= _native.MIN_NATIVE_N else None
    if lib is not None:
        out = np.empty((n, 3), np.uint8)
        lib.spz_decode_colors(np.ascontiguousarray(colors, np.uint8), n, out)
        return out
    return cast_u8(colors.astype(np.float32) * _COLOR_FRAC_A_B + _COLOR_C)


def encode_colors(color_rgb: np.ndarray) -> np.ndarray:
    """IR u8 colors -> SPZ u8 colors (reference: src/gaussian.rs:300-307)."""
    n = color_rgb.shape[0]
    lib = _native.get_lib() if n >= _native.MIN_NATIVE_N else None
    if lib is not None:
        out = np.empty((n, 3), np.uint8)
        lib.spz_encode_colors(
            np.ascontiguousarray(color_rgb, np.uint8), n, out
        )
        return out
    return cast_u8((color_rgb.astype(np.float32) - _COLOR_C) / _COLOR_FRAC_A_B)


def decode_shs(shs: np.ndarray) -> np.ndarray:
    """u8[N,K,3] -> f32 coefficients (reference: src/gaussian.rs:205-208)."""
    count = int(shs.size)
    lib = _native.get_lib() if count >= _native.MIN_NATIVE_N else None
    if lib is not None:
        out = np.empty(shs.shape, np.float32)
        lib.spz_decode_sh(
            np.ascontiguousarray(shs, np.uint8), count, out.reshape(-1)
        )
        return out
    return ((shs.astype(np.float32) - F32(128.0)) / F32(128.0)).astype(np.float32)


def encode_shs(sh: np.ndarray, sh_degree: int, sh_quantize_bits) -> np.ndarray:
    """f32[N,15,3] -> u8[N,K,3] with bucket quantization (reference:
    src/gaussian.rs:309-342, quantize_sh at 319-327).

    The bucket size is selected by the *header* SH degree for every
    coefficient, matching the reference (gaussian.rs:329-334).
    """
    num_coeffs = SH_DEGREE_TO_NUM_COEFFS[sh_degree]
    n = sh.shape[0]
    if num_coeffs == 0:
        return np.zeros((n, 0, 3), dtype=np.uint8)
    x = np.ascontiguousarray(sh[:, :num_coeffs, :], np.float32)
    bits_ = sh_quantize_bits[sh_degree - 1]
    bucket_ = 1 << (8 - bits_)
    lib = _native.get_lib() if x.size >= _native.MIN_NATIVE_N else None
    if lib is not None:
        out = np.empty(x.shape, np.uint8)
        lib.spz_encode_sh(x, int(x.size), bucket_, out.reshape(-1))
        return out
    # Rust: (x * 128 + 128).round() as u32 — negative rounds saturate to 0.
    q = rust_round(x * F32(128.0) + F32(128.0))
    q = np.clip(q, 0.0, 2.0**32 - 1).astype(np.int64)
    bits = sh_quantize_bits[sh_degree - 1]
    bucket = 1 << (8 - bits)
    # The reference buckets only when bucket_size < 8 (gaussian.rs:320-326).
    if bucket < 8:
        q = (q + bucket // 2) // bucket * bucket
    return np.clip(q, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Columnar container + I/O
# ---------------------------------------------------------------------------


class SpzGaussians:
    """Columnar SPZ gaussian collection (reference: spz.rs:684-703).

    Field shapes/dtypes by header:
    - positions: u16[N,3] (v1 float16) or u8[N,3,3] (v2/3 fixed-point-24)
    - scales:    u8[N,3]
    - rotations: u8[N,3] (v1/2 first-three) or u8[N,4] (v3 smallest-three)
    - alphas:    u8[N]
    - colors:    u8[N,3]
    - shs:       u8[N,K,3] with K = {0,3,8,15} by SH degree
    """

    def __init__(self, header: SpzHeader, positions, scales, rotations, alphas,
                 colors, shs):
        self.header = header
        self.positions = np.asarray(positions)
        self.scales = np.asarray(scales, dtype=np.uint8)
        self.rotations = np.asarray(rotations, dtype=np.uint8)
        self.alphas = np.asarray(alphas, dtype=np.uint8)
        self.colors = np.asarray(colors, dtype=np.uint8)
        self.shs = np.asarray(shs, dtype=np.uint8)
        self._validate()

    def _validate(self):
        """Shape validation — the analog of the reference's from_iter
        variant/count checks (spz.rs:836-914)."""
        h = self.header
        n = h.num_points
        if self.positions.shape[0] != n:
            raise SpzCountMismatchError(
                actual_count=self.positions.shape[0], header_count=n
            )
        is_f16 = self.positions.dtype == np.uint16
        if is_f16 != h.uses_float16:
            raise SpzPositionFloat16MismatchError(
                is_float16=is_f16, header_uses_float16=h.uses_float16
            )
        is_s3 = self.rotations.shape[-1] == 4
        if is_s3 != h.uses_quat_smallest_three:
            raise SpzRotationQuatSmallestThreeMismatchError(
                is_quat_smallest_three=is_s3,
                header_uses_quat_smallest_three=h.uses_quat_smallest_three,
            )
        data_deg = NUM_COEFFS_TO_SH_DEGREE.get(self.shs.shape[1])
        if data_deg != h.sh_degree:
            raise SpzShDegreeMismatchError(
                sh_degree=-1 if data_deg is None else data_deg,
                header_sh_degree=h.sh_degree,
            )

    def __len__(self) -> int:
        return self.header.num_points

    @classmethod
    def from_batches(cls, batches) -> "SpzGaussians":
        """Collect SpzGaussians batches into one — the FromIterator analog
        (reference: spz.rs:836-914 collects per-gaussian field enums; the
        SoA design collects whole columnar batches).

        Raises :class:`SpzEmptyIteratorError` on an empty iterator
        (reference: src/error.rs:47-48) and
        :class:`SpzInvalidMixedVariantError` when batches mix field
        encodings — position f16 vs fixed-24 (and fractional bits),
        rotation first-three vs smallest-three, or SH degree (reference:
        src/error.rs:30-39, the InvalidMixed*Variant arms).
        """
        batches = list(batches)
        if not batches:
            raise SpzEmptyIteratorError("empty SPZ gaussian iterator")
        first = batches[0].header
        for b in batches[1:]:
            h = b.header
            if (h.uses_float16 != first.uses_float16
                    or h.fractional_bits != first.fractional_bits):
                raise SpzInvalidMixedVariantError(
                    field="position",
                    first_variant=(
                        "f16" if first.uses_float16
                        else f"fixed24/{first.fractional_bits}"
                    ),
                    current_variant=(
                        "f16" if h.uses_float16
                        else f"fixed24/{h.fractional_bits}"
                    ),
                )
            if h.uses_quat_smallest_three != first.uses_quat_smallest_three:
                raise SpzInvalidMixedVariantError(
                    field="rotation",
                    first_variant="smallest-three"
                    if first.uses_quat_smallest_three else "first-three",
                    current_variant="smallest-three"
                    if h.uses_quat_smallest_three else "first-three",
                )
            if h.sh_degree != first.sh_degree:
                raise SpzInvalidMixedVariantError(
                    field="sh",
                    first_variant=first.sh_degree,
                    current_variant=h.sh_degree,
                )
        header = SpzHeader(
            version=first.version,
            num_points=sum(len(b) for b in batches),
            sh_degree=first.sh_degree,
            fractional_bits=first.fractional_bits,
            antialiased=first.antialiased,
        )
        return cls(
            header,
            np.concatenate([b.positions for b in batches]),
            np.concatenate([b.scales for b in batches]),
            np.concatenate([b.rotations for b in batches]),
            np.concatenate([b.alphas for b in batches]),
            np.concatenate([b.colors for b in batches]),
            np.concatenate([b.shs for b in batches]),
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SpzGaussians)
            and self.header == other.header
            and np.array_equal(self.positions, other.positions)
            and np.array_equal(self.scales, other.scales)
            and np.array_equal(self.rotations, other.rotations)
            and np.array_equal(self.alphas, other.alphas)
            and np.array_equal(self.colors, other.colors)
            and np.array_equal(self.shs, other.shs)
        )

    # ------------------------------------------------------------------ I/O

    @classmethod
    def read_decompressed(cls, reader: BinaryIO) -> "SpzGaussians":
        """Read header + columnar body (reference: spz.rs:716-771)."""
        header = SpzHeader.from_bytes(_read_exact(reader, 16))
        n = header.num_points
        k = header.sh_num_coefficients

        if header.uses_float16:
            positions = np.frombuffer(
                _read_exact(reader, n * 6), dtype="<u2"
            ).reshape(n, 3)
        else:
            positions = np.frombuffer(
                _read_exact(reader, n * 9), dtype=np.uint8
            ).reshape(n, 3, 3)
        alphas = np.frombuffer(_read_exact(reader, n), dtype=np.uint8)
        colors = np.frombuffer(_read_exact(reader, n * 3), dtype=np.uint8).reshape(
            n, 3
        )
        scales = np.frombuffer(_read_exact(reader, n * 3), dtype=np.uint8).reshape(
            n, 3
        )
        rot_width = 4 if header.uses_quat_smallest_three else 3
        rotations = np.frombuffer(
            _read_exact(reader, n * rot_width), dtype=np.uint8
        ).reshape(n, rot_width)
        shs = np.frombuffer(_read_exact(reader, n * k * 3), dtype=np.uint8).reshape(
            n, k, 3
        )
        return cls(header, positions, scales, rotations, alphas, colors, shs)

    def write_decompressed(self, writer: BinaryIO) -> None:
        """Write header + columnar body (reference: spz.rs:776-794)."""
        writer.write(self.header.to_bytes())
        if self.header.uses_float16:
            writer.write(np.ascontiguousarray(self.positions, dtype="<u2").tobytes())
        else:
            writer.write(self.positions.tobytes())
        writer.write(self.alphas.tobytes())
        writer.write(self.colors.tobytes())
        writer.write(self.scales.tobytes())
        writer.write(self.rotations.tobytes())
        writer.write(self.shs.tobytes())

    @classmethod
    def read_from(cls, reader: BinaryIO) -> "SpzGaussians":
        """Read a gzip-compressed SPZ stream (reference: spz.rs:945-950)."""
        with gzip.GzipFile(fileobj=reader, mode="rb") as gz:
            return cls.read_decompressed(gz)

    @classmethod
    def read_from_file(cls, path) -> "SpzGaussians":
        with open(path, "rb") as f:
            return cls.read_from(f)

    def write_to(self, writer: BinaryIO) -> None:
        """Write a gzip-compressed SPZ stream (reference: spz.rs:952-959)."""
        with gzip.GzipFile(fileobj=writer, mode="wb") as gz:
            self.write_decompressed(gz)

    def write_to_file(self, path) -> None:
        with open(path, "wb") as f:
            self.write_to(f)


def _read_exact(reader: BinaryIO, n: int) -> bytes:
    buf = reader.read(n)
    if buf is None or len(buf) < n:
        raise IOError(
            f"unexpected EOF in SPZ stream: got {0 if buf is None else len(buf)} "
            f"of {n} bytes"
        )
    return buf


def read_spz(source: Union[str, BinaryIO]) -> SpzGaussians:
    """Convenience entry point: path or binary stream -> SpzGaussians."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        return SpzGaussians.read_from_file(source)
    return SpzGaussians.read_from(source)
