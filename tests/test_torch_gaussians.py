"""The torch port's ``GaussianSoA`` and ``Gaussians`` dispatcher against
the JAX package's, bit for bit.

The cases of tests/test_gaussian.py: the SoA accessors, the source
dispatch, ``from_soa``/``to_soa`` for each source, file and stream round
trips (written by one package, read by the other), the INTERNAL source's
I/O errors and PLY -> IR -> SPZ -> IR; on the reference's seeded pair, a
seeded scene above MIN_NATIVE_N and the repo's example files.
"""

import io

import numpy as np
import pytest

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu import models as JM
from wgpu_3dgs_core_tpu_torch import models as TM

from .common import (
    SPZ_DEFAULT_TOLERANCES,
    assert_gaussians_close,
    gaussians_soa,
)
from .test_torch_spz import (
    EXAMPLE_SPZ,
    SOA_FIELDS,
    assert_soa_equal,
    seeded_soa,
)
from .torch_parity import EXAMPLE_PLY

SOURCES = ("internal", "ply", "spz")


def _pair(n):
    """The reference's seeded pair (tests/common.py) for n == 2, else a
    seeded scene, as (port SoA, JAX SoA)."""
    if n == 2:
        arrays = {f: getattr(gaussians_soa(), f) for f in SOA_FIELDS}
    else:
        arrays = seeded_soa(n, seed=5)
    return T.GaussianSoA(**arrays), J.GaussianSoA(**arrays)


def _data_equal(mine, ref):
    """The payload of two Gaussians, compared field by field."""
    if isinstance(ref, J.GaussianSoA):
        assert_soa_equal(mine, ref)
    elif isinstance(ref, J.PlyGaussians):
        np.testing.assert_array_equal(mine.block, ref.block)
    else:
        buf_a, buf_b = io.BytesIO(), io.BytesIO()
        mine.write_decompressed(buf_a)
        ref.write_decompressed(buf_b)
        assert buf_a.getvalue() == buf_b.getvalue()


def test_exports_match_jax():
    assert TM.__all__ == JM.__all__
    for name in JM.__all__:
        assert hasattr(T, name), name
    assert [s.value for s in T.GaussiansSource] == list(SOURCES)
    assert T.SPZ_SH0_TO_LINEAR_FACTOR == J.SPZ_SH0_TO_LINEAR_FACTOR


def test_soa_accessors_bit_identical():
    mine, ref = _pair(2)
    assert len(mine) == 2
    assert_soa_equal(mine.at(1), ref.at(1))
    assert_soa_equal(mine[0], ref[0])
    assert_soa_equal(T.GaussianSoA.concatenate([mine.at(0), mine[1]]), ref)
    assert_soa_equal(T.GaussianSoA.zeros(4), J.GaussianSoA.zeros(4))


def test_source_dispatch():
    mine, _ = _pair(2)
    for source, data in zip(T.GaussiansSource,
                            (mine, mine.to_ply(), mine.to_spz())):
        g = T.Gaussians(data)
        assert g.source == source and len(g) == 2 and not g.is_empty
        if source == T.GaussiansSource.INTERNAL:
            assert g.to_soa() is data
    assert T.Gaussians(T.GaussianSoA.zeros(0)).is_empty


@pytest.mark.parametrize("source", SOURCES)
def test_from_soa_to_soa_bit_identical(source):
    for n in (2, 5000):
        mine, ref = _pair(n)
        gm = T.Gaussians.from_soa(mine, T.GaussiansSource(source))
        gj = J.Gaussians.from_soa(ref, J.GaussiansSource(source))
        assert gm.source.value == source
        _data_equal(gm.data, gj.data)
        assert_soa_equal(gm.to_soa(), gj.to_soa())
        if n == 2 and source == "spz":  # the v3 quaternion swap needs the
            # reference's near-symmetric pair (tests/test_gaussian.py)
            assert_gaussians_close(mine, gm.to_soa(), SPZ_DEFAULT_TOLERANCES)


@pytest.mark.parametrize("source", ["ply", "spz"])
def test_files_and_streams_cross_between_packages(source, tmp_path):
    mine, ref = _pair(5000)
    gm = T.Gaussians.from_soa(mine, T.GaussiansSource(source))
    gj = J.Gaussians.from_soa(ref, J.GaussiansSource(source))
    gm.write_to_file(tmp_path / f"port.{source}")
    gj.write_to_file(tmp_path / f"jax.{source}")
    for name in ("port", "jax"):
        path = tmp_path / f"{name}.{source}"
        back = T.Gaussians.read_from_file(path, T.GaussiansSource(source))
        assert back.source.value == source
        _data_equal(back.data, J.Gaussians.read_from_file(
            path, J.GaussiansSource(source)).data)
        assert back.data == gm.data
    buf = io.BytesIO()
    gj.write_to(buf)
    buf.seek(0)
    assert T.Gaussians.read_from(buf, T.GaussiansSource(source)).data == (
        gm.data)


def test_internal_io_errors_match_jax(tmp_path):
    cases = [
        lambda m: m.Gaussians(m.GaussianSoA.zeros(1)).write_to(io.BytesIO()),
        lambda m: m.Gaussians(m.GaussianSoA.zeros(1)).write_to_file(
            tmp_path / "never.bin"),
        lambda m: m.Gaussians.read_from(io.BytesIO(),
                                        m.GaussiansSource.INTERNAL),
        lambda m: m.Gaussians.read_from_file(tmp_path / "never.bin",
                                             m.GaussiansSource.INTERNAL),
    ]
    for case in cases:
        with pytest.raises(IOError) as mine:
            case(T)
        with pytest.raises(IOError) as ref:
            case(J)
        assert str(mine.value) == str(ref.value)
    assert not (tmp_path / "never.bin").exists()


def test_cross_format_conversion_bit_identical():
    """PLY -> IR -> SPZ -> IR on the reference's pair (tests/test_gaussian.py
    holds it within SPZ's default tolerances), and the repo's example files
    through the dispatcher."""
    mine, ref = _pair(2)
    got = T.GaussianSoA.from_spz(T.GaussianSoA.from_ply(
        mine.to_ply()).to_spz())
    want = J.GaussianSoA.from_spz(J.GaussianSoA.from_ply(
        ref.to_ply()).to_spz())
    assert_soa_equal(got, want)
    assert_gaussians_close(mine, got, SPZ_DEFAULT_TOLERANCES)
    for path, source in ((EXAMPLE_PLY, "ply"), (EXAMPLE_SPZ, "spz")):
        assert_soa_equal(
            T.Gaussians.read_from_file(path, T.GaussiansSource(source))
            .to_soa(),
            J.Gaussians.read_from_file(str(path), J.GaussiansSource(source))
            .to_soa())
