"""The torch port's SPZ format against the JAX package's, bit for bit.

``read_spz``, ``SpzGaussians`` (its fields, header and the bytes it
writes) and ``GaussianSoA.from_spz``/``to_spz`` on the repo's
``examples/model.spz`` and on seeded scenes on both sides of
``MIN_NATIVE_N`` (the numpy codecs below it, the native ones above), over
versions 1-3, SH degrees 0-3, SH bits 2/4/5/8, fractional bits 6/12/18 and
the antialiased flag; files written by one package read by the other.
The cases mirror tests/test_spz.py, whose reference-asset cases read
the repo's examples here.
"""

import gzip
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu_torch.utils import native

from .common import SPZ_LOOSE_TOLERANCES, assert_gaussians_close
from .torch_parity import EXAMPLE_PLY

REPO = Path(__file__).resolve().parents[1]
EXAMPLE_SPZ = REPO / "examples" / "model.spz"
SPZ_FIELDS = ("positions", "scales", "rotations", "alphas", "colors", "shs")
SOA_FIELDS = ("rot", "pos", "color", "sh", "scale")
# n below and above MIN_NATIVE_N (SH codecs switch on n * K * 3 values).
SIZES = (2, 5000)


def seeded_soa(n, seed=0):
    """A seeded scene in the numpy form both packages take."""
    rng = np.random.default_rng(seed)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return dict(
        rot=rot,
        pos=(rng.random((n, 3), dtype=np.float32) * 100 - 50),
        color=rng.integers(0, 256, (n, 4)).astype(np.uint8),
        sh=(rng.random((n, 15, 3), dtype=np.float32) * 2 - 1),
        scale=(rng.random((n, 3), dtype=np.float32) * 5 + 1e-3),
    )


def assert_spz_equal(mine, ref):
    assert type(mine).__module__.startswith("wgpu_3dgs_core_tpu_torch")
    assert mine.header.__dict__ == ref.header.__dict__
    for f in SPZ_FIELDS:
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert decompressed(mine) == decompressed(ref)


def assert_soa_equal(mine, ref):
    for f in SOA_FIELDS:
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f


def decompressed(spz) -> bytes:
    buf = io.BytesIO()
    spz.write_decompressed(buf)
    return buf.getvalue()


def test_example_spz_bit_identical():
    mine, ref = T.read_spz(str(EXAMPLE_SPZ)), J.read_spz(str(EXAMPLE_SPZ))
    assert (len(mine), mine.header.version, mine.header.sh_degree,
            mine.header.fractional_bits) == (3, 2, 3, 12)
    assert_spz_equal(mine, ref)
    with open(EXAMPLE_SPZ, "rb") as f:
        raw = gzip.decompress(f.read())
    assert decompressed(mine) == raw
    assert_soa_equal(T.GaussianSoA.from_spz(mine),
                     J.GaussianSoA.from_spz(ref))


def test_example_ply_and_spz_agree():
    """examples/model.spz was written from the scene of examples/model.ply
    (examples/write_spz.py): both decode to nearly the same gaussians, and
    each package decodes both to the same bits."""
    ply = T.GaussianSoA.from_ply(T.read_ply(EXAMPLE_PLY))
    spz = T.GaussianSoA.from_spz(T.read_spz(str(EXAMPLE_SPZ)))
    assert_gaussians_close(ply, spz, SPZ_LOOSE_TOLERANCES)
    assert_soa_equal(ply, J.GaussianSoA.from_ply(J.read_ply(str(EXAMPLE_PLY))))


OPTIONS = [
    dict(version=1, sh_degree=0),
    dict(version=2, sh_degree=1, fractional_bits=6,
         sh_quantize_bits=(2, 2, 2)),
    dict(version=3, sh_degree=2, sh_quantize_bits=(4, 4, 4),
         antialiased=True),
    dict(version=3, sh_degree=3, sh_quantize_bits=(8, 8, 8)),
    dict(version=2, sh_degree=3, fractional_bits=18),  # fixed24 wraps
    dict(),  # the defaults: v3, sh_deg 3, frac 12, bits (5, 4, 4)
]


@pytest.mark.parametrize("opts", OPTIONS,
                         ids=lambda o: "-".join(f"{k}{v}" for k, v in
                                                o.items()) or "defaults")
def test_to_spz_and_back_bit_identical(opts):
    for n in SIZES:
        arrays = seeded_soa(n, seed=n)
        mine = T.GaussianSoA(**arrays).to_spz(T.SpzEncodeOptions(**opts))
        ref = J.GaussianSoA(**arrays).to_spz(J.SpzEncodeOptions(**opts))
        assert_spz_equal(mine, ref)
        soa = T.GaussianSoA.from_spz(mine)
        assert_soa_equal(soa, J.GaussianSoA.from_spz(ref))
        k = {0: 0, 1: 3, 2: 8, 3: 15}[mine.header.sh_degree]
        assert (soa.sh[:, k:] == 0).all()  # truncated coefficients
        back = T.SpzGaussians.read_decompressed(io.BytesIO(
            decompressed(ref)))
        assert back == mine


def test_defaults_equal_jax():
    assert T.SpzEncodeOptions() == T.SpzEncodeOptions(
        **J.SpzEncodeOptions().__dict__)
    assert T.SpzHeader.default(7).__dict__ == J.SpzHeader.default(7).__dict__
    assert T.SPZ_SH0_TO_LINEAR_FACTOR == J.SPZ_SH0_TO_LINEAR_FACTOR
    assert T.SpzHeader.default(7).to_bytes() == J.SpzHeader.default(
        7).to_bytes()


def test_files_cross_between_packages(tmp_path):
    """A file written by either package reads back equal in both, through
    a path, a stream and read_spz; gzip streams differ only in their
    header's mtime."""
    arrays = seeded_soa(5000, seed=1)
    mine = T.GaussianSoA(**arrays).to_spz()
    ref = J.GaussianSoA(**arrays).to_spz()
    mine.write_to_file(tmp_path / "port.spz")
    ref.write_to_file(tmp_path / "jax.spz")
    for path in (tmp_path / "port.spz", tmp_path / "jax.spz"):
        assert_spz_equal(T.read_spz(str(path)), J.read_spz(str(path)))
        assert T.read_spz(path) == mine
        with open(path, "rb") as f:
            assert T.read_spz(f) == mine
    a, b = io.BytesIO(), io.BytesIO()
    mine.write_to(a)
    ref.write_to(b)
    a, b = a.getvalue(), b.getvalue()
    assert a[:4] + a[8:] == b[:4] + b[8:]


def test_from_batches_bit_identical():
    parts = [seeded_soa(n, seed=n) for n in (3, 4100)]
    mine = T.SpzGaussians.from_batches(
        [T.GaussianSoA(**p).to_spz() for p in parts])
    ref = J.SpzGaussians.from_batches(
        [J.GaussianSoA(**p).to_spz() for p in parts])
    assert len(mine) == 4103
    assert_spz_equal(mine, ref)


def test_models_import_and_round_trip_with_jax_blocked():
    """In a fresh interpreter where importing jax or the JAX package
    fails, the port's models import and an SPZ round trip runs on the
    native codec."""
    code = (
        "import sys, io\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib',"
        " 'wgpu_3dgs_core_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from wgpu_3dgs_core_tpu_torch import models\n"
        "from wgpu_3dgs_core_tpu_torch.utils import native\n"
        "soa = models.GaussianSoA.zeros(5000)\n"
        "g = models.Gaussians.from_soa(soa, models.GaussiansSource.SPZ)\n"
        "buf = io.BytesIO(); g.write_to(buf); buf.seek(0)\n"
        "back = models.Gaussians.read_from(buf, models.GaussiansSource.SPZ)\n"
        "assert back.data == g.data and len(back.to_soa()) == 5000\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'wgpu_3dgs_core_tpu')]\n"
        "print(native.available())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(native.available())
