"""The torch port's SPZ codecs and SPZ errors against the JAX package's.

Every codec function of models/spz.py, port against JAX, bit for bit on
the numpy path (n below MIN_NATIVE_N) and the native one (above it); the
Rust semantics the codecs copy (the v3 smallest-three bit layout,
``max_by``'s last-maximum rule, fixed24 wrapping); and the same error
class, with the same message, on each malformed input of
tests/test_spz.py.
"""

import io
import struct

import numpy as np
import pytest

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu.models import spz as JS
from wgpu_3dgs_core_tpu_torch.models import spz as TS
from wgpu_3dgs_core_tpu_torch.utils import native

from .test_torch_spz import seeded_soa


def _header(mod, version, n, sh_degree=3, frac=12):
    return mod.SpzHeader(version=version, num_points=n, sh_degree=sh_degree,
                         fractional_bits=frac)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n", [60, 5000], ids=["numpy", "native"])
def test_codec_functions_bit_identical(n):
    """60 gaussians keep every codec, SH's n * 45 values included, below
    MIN_NATIVE_N; 5000 take every one above it."""
    s = seeded_soa(n, seed=n)
    for version in (1, 2, 3):
        th, jh = _header(TS, version, n), _header(JS, version, n)
        for frac in (6, 12):
            th2, jh2 = _header(TS, version, n, frac=frac), _header(
                JS, version, n, frac=frac)
            enc = TS.encode_positions(s["pos"], th2)
            _same(enc, JS.encode_positions(s["pos"], jh2))
            _same(TS.decode_positions(enc, th2),
                  JS.decode_positions(enc, jh2))
        enc = TS.encode_rotations(s["rot"], th)
        _same(enc, JS.encode_rotations(s["rot"], jh))
        _same(TS.decode_rotations(enc, th), JS.decode_rotations(enc, jh))
    enc = TS.encode_scales(s["scale"])
    _same(enc, JS.encode_scales(s["scale"]))
    _same(TS.decode_scales(enc), JS.decode_scales(enc))
    enc = TS.encode_colors(s["color"][:, :3])
    _same(enc, JS.encode_colors(s["color"][:, :3]))
    _same(TS.decode_colors(enc), JS.decode_colors(enc))
    for deg in range(4):
        for bits in (2, 4, 5, 8):
            q = (bits, bits, bits)
            enc = TS.encode_shs(s["sh"], deg, q)
            _same(enc, JS.encode_shs(s["sh"], deg, q))
            _same(TS.decode_shs(enc), JS.decode_shs(enc))


def test_v3_quat_codec_bit_layout():
    """tests/test_spz.py's pin of the v3 smallest-three layout: the first
    non-largest component is written into the highest bits, and read back
    from the lowest, so x and z swap on a round trip."""
    header = _header(TS, 3, 1, sh_degree=0)
    q = np.array([[0.1, 0.2, 0.3, 0.9273618]], dtype=np.float32)
    packed = TS.encode_rotations(q, header)
    _same(packed, JS.encode_rotations(q, _header(JS, 3, 1, sh_degree=0)))
    comp = int.from_bytes(packed[0].tobytes(), "little")
    assert comp >> 30 == 3
    assert (comp >> 20) & 511 == int(np.trunc(511 * (0.1 * np.sqrt(2)) + 0.5))
    decoded = TS.decode_rotations(packed, header)
    np.testing.assert_allclose(decoded[0, [0, 2]], [0.3, 0.1], atol=2e-3)


@pytest.mark.parametrize("n", [4, 4096], ids=["numpy", "native"])
def test_max_by_ties_take_the_last_maximum(n):
    """Rust's max_by keeps the last of equal maxima: a quaternion whose
    largest |component| ties picks the highest index, on both paths and in
    both packages."""
    ties = np.array([[0.5, 0.5, 0.5, 0.5], [0.6, -0.6, 0.3, 0.3],
                     [-0.7, 0.1, 0.7, 0.1], [0.5, -0.5, -0.5, -0.5]],
                    dtype=np.float32)
    q = np.tile(ties, (n // 4, 1))
    packed = TS.encode_rotations(q, _header(TS, 3, n))
    _same(packed, JS.encode_rotations(q, _header(JS, 3, n)))
    largest = packed[:4, 3] >> 6
    np.testing.assert_array_equal(largest, [3, 1, 2, 3])


def test_fixed24_overflow_wraps_bit_identical():
    """Positions beyond the 24-bit range wrap, as the reference's byte
    masking does (tests/test_spz.py: frac 18 holds +-32)."""
    for n in (2, 5000):
        s = seeded_soa(n, seed=3)
        opts = dict(version=2, fractional_bits=18)
        back = T.GaussianSoA.from_spz(
            T.GaussianSoA(**s).to_spz(T.SpzEncodeOptions(**opts)))
        ref = J.GaussianSoA.from_spz(
            J.GaussianSoA(**s).to_spz(J.SpzEncodeOptions(**opts)))
        _same(back.pos, ref.pos)
        period = np.float32(2**24 / 2**18)
        wrapped = (s["pos"] + period / 2) % period - period / 2
        np.testing.assert_allclose(back.pos, wrapped, atol=0.01, rtol=0)


def _header_cases(m):
    good = m.SpzHeader.default(1).to_bytes()
    return [
        lambda: m.SpzHeader.from_bytes(b"XXXX" + good[4:]),
        lambda: m.SpzHeader.from_bytes(
            struct.pack("<IIIBBBB", 0x5053474E, 4, 1, 3, 12, 0, 0)),
        lambda: m.SpzHeader.from_bytes(
            struct.pack("<IIIBBBB", 0x5053474E, 3, 1, 5, 12, 0, 0)),
        lambda: m.SpzGaussians.read_decompressed(io.BytesIO(good[:10])),
    ]


def _container_cases(m):
    s = seeded_soa(2)
    v3 = m.GaussianSoA(**s).to_spz()
    v2 = m.GaussianSoA(**s).to_spz(m.SpzEncodeOptions(version=2))
    body = io.BytesIO()
    v3.write_decompressed(body)

    def build(header, spz, rotations=None):
        return lambda: m.SpzGaussians(
            header, spz.positions, spz.scales,
            spz.rotations if rotations is None else rotations, spz.alphas,
            spz.colors, spz.shs)

    return [
        build(_header(m, 3, 5), v3),
        build(_header(m, 1, 2), v3, v3.rotations[:, :3]),
        build(_header(m, 3, 2), v2),
        build(_header(m, 3, 2, sh_degree=1), v3),
        lambda: m.SpzGaussians.read_decompressed(
            io.BytesIO(body.getvalue()[:-4])),
    ]


def _batch_cases(m):
    s = seeded_soa(2)

    def spz(**opts):
        return m.GaussianSoA(**s).to_spz(m.SpzEncodeOptions(**opts))

    return [
        lambda: m.SpzGaussians.from_batches([]),
        lambda: m.SpzGaussians.from_batches([spz(version=1),
                                             spz(version=2)]),
        lambda: m.SpzGaussians.from_batches([spz(version=2),
                                             spz(version=3)]),
        lambda: m.SpzGaussians.from_batches([spz(sh_degree=3),
                                             spz(sh_degree=1)]),
    ]


def _raised(case):
    with pytest.raises(Exception) as info:
        case()
    return info.value


@pytest.mark.parametrize("cases", [_header_cases, _container_cases,
                                   _batch_cases],
                         ids=["header", "container", "batches"])
def test_malformed_inputs_raise_the_same_errors(cases):
    for mine, ref in zip(cases(T), cases(J), strict=True):
        a, b = _raised(mine), _raised(ref)
        assert type(a).__name__ == type(b).__name__
        assert type(a).__mro__[1].__name__ == type(b).__mro__[1].__name__
        assert str(a) == str(b)
        if type(b).__module__.startswith("wgpu_3dgs_core_tpu."):
            assert type(a).__module__.startswith("wgpu_3dgs_core_tpu_torch")


def test_codecs_switch_paths_at_min_native_n(monkeypatch):
    """Below MIN_NATIVE_N the codecs never ask for the library."""
    asked = []
    monkeypatch.setattr(native, "get_lib",
                        lambda: asked.append(1) or None)
    s = seeded_soa(native.MIN_NATIVE_N - 1)
    TS.encode_scales(s["scale"])
    assert not asked
    TS.encode_scales(np.ones((native.MIN_NATIVE_N, 3), np.float32))
    assert asked
