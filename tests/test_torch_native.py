"""The torch port's native SPZ codec (utils/native.py, its own build of
csrc/spz_codec.cpp) against its numpy path and the JAX package's codecs.

The cases of tests/test_native.py: native against numpy on every codec
above MIN_NATIVE_N, each path bit for bit the JAX package's same path;
where native and numpy differ at all (a scale code on a rounding tie,
where numpy's f32 log and the C library's logf round apart), the
difference is pinned. Then the build: into the package's
``_build/spz/<key>/``, never next to the root ``csrc/``, atomic under
concurrent builds, and the loader's numpy fallback on each failure.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from wgpu_3dgs_core_tpu.models import spz as JS
from wgpu_3dgs_core_tpu.utils import native as jnative
from wgpu_3dgs_core_tpu_torch import GaussianSoA
from wgpu_3dgs_core_tpu_torch.models import spz as TS
from wgpu_3dgs_core_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]
N = 20_000  # above MIN_NATIVE_N: the native path engages


@pytest.fixture(autouse=True)
def _both_libraries():
    if not (native.available() and jnative.available()):
        pytest.fail("a native codec did not build: g++ is expected here")


def _paths(fn, *args):
    """fn on the native path, then on the numpy path, of the port and of
    the JAX package: (port native, port numpy, JAX native, JAX numpy). A
    header argument is handed to each package as its own SpzHeader."""
    out = []
    for mod, lib in ((TS, native), (JS, jnative)):
        margs = [mod.SpzHeader(**a.__dict__)
                 if isinstance(a, TS.SpzHeader) else a for a in args]
        out.append(getattr(mod, fn)(*margs))
        get = lib.get_lib
        lib.get_lib = lambda: None
        try:
            out.append(getattr(mod, fn)(*margs))
        finally:
            lib.get_lib = get
    return out


def _same(a, b):
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("version", [2, 3])
def test_codecs_native_equal_numpy_and_jax(version):
    header = TS.SpzHeader(version=version, num_points=N, sh_degree=0,
                          fractional_bits=12)
    rng = _rng()
    pos = rng.random((N, 3), dtype=np.float32) * 100 - 50
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scale = rng.random((N, 3), dtype=np.float32) * 5 + 1e-3
    color = rng.integers(0, 256, (N, 3)).astype(np.uint8)
    for name, x, hdr, exact in (("positions", pos, (header,), True),
                                ("rotations", q, (header,), False),
                                ("scales", scale, (), False),
                                ("colors", color, (), True)):
        tn, tp, jn, jp = _paths(f"encode_{name}", x, *hdr)
        for a, b in ((tn, tp), (tn, jn), (tp, jp)):
            _same(a, b)
        dn, dp, djn, djp = _paths(f"decode_{name}", tn, *hdr)
        _same(dn, djn)
        _same(dp, djp)
        if exact:
            _same(dn, dp)
        else:  # tests/test_native.py's bars: sqrt and exp may round apart
            np.testing.assert_allclose(dn, dp, rtol=1e-6, atol=1e-6)


def test_sh_native_equal_numpy_and_jax():
    sh = _rng().random((N, 15, 3), dtype=np.float32) * 2 - 1
    for bits in (2, 4, 5, 8):
        q = (bits, bits, bits)
        tn, tp, jn, jp = _paths("encode_shs", sh, 3, q)
        for a, b in ((tn, tp), (tn, jn), (tp, jp)):
            _same(a, b)
        dn, dp, djn, djp = _paths("decode_shs", tn)
        for a, b in ((dn, dp), (dn, djn), (dp, djp)):
            _same(a, b)


def test_full_file_native_matches_numpy(monkeypatch):
    rng = _rng()
    soa = GaussianSoA(
        rot=rng.normal(size=(N, 4)).astype(np.float32),
        pos=(rng.random((N, 3), dtype=np.float32) * 10 - 5),
        color=rng.integers(0, 256, (N, 4)).astype(np.uint8),
        sh=(rng.random((N, 15, 3), dtype=np.float32) * 2 - 1),
        scale=(rng.random((N, 3), dtype=np.float32) + 0.01),
    )
    soa.rot /= np.linalg.norm(soa.rot, axis=1, keepdims=True)
    spz_native = soa.to_spz()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert soa.to_spz() == spz_native


def test_scale_codes_on_a_rounding_tie():
    """Scales whose code 16 (ln s + 10) sits on a half: each package's
    native path equals the other's and so does its numpy path; where the
    two paths part (numpy's f32 log against logf), it is by one step, on
    the tie."""
    k = np.arange(40, 120, dtype=np.float64)
    s = np.exp((k + 0.5) / 16.0 - 10.0).astype(np.float32)
    ulps = np.arange(-3, 4, dtype=np.int32)
    cand = (s.view(np.int32)[:, None] + ulps[None, :]).view(np.float32)
    scale = np.resize(cand.reshape(-1), (4096, 3))
    tn, tp, jn, jp = _paths("encode_scales", scale)
    _same(tn, jn)
    _same(tp, jp)
    diff = tn != tp
    assert np.abs(tn[diff].astype(np.int32) - tp[diff]).max(initial=0) <= 1
    code = (np.log(scale[diff].astype(np.float64)) + 10.0) * 16.0
    assert (np.abs(code - np.floor(code) - 0.5) <= 1e-4).all()


def _csrc_state():
    return sorted((p.name, p.stat().st_mtime_ns, p.stat().st_size)
                  for p in (REPO / "csrc").iterdir())


def test_build_lands_under_build_dir_and_leaves_csrc():
    before = _csrc_state()
    assert native.SOURCE.read_bytes() == (REPO / "csrc" /
                                          "spz_codec.cpp").read_bytes()
    path = native.build()
    assert path.parent.parent == native.PACKAGE_DIR / "_build" / "spz"
    assert path.parent.name == native.build_key(native.CXX_FLAGS
                                                + native.OPENMP_FLAGS)
    assert ctypes.CDLL(str(path)).spz_codec_abi_version() == 1
    assert Path(native.get_lib()._name) == path
    assert _csrc_state() == before


def test_concurrent_builds_share_one_library(tmp_path):
    """Four processes build into one empty directory at once: each loads
    the same library, and no temporary file of a build is left."""
    code = (
        "import sys; from pathlib import Path\n"
        "from wgpu_3dgs_core_tpu_torch.utils import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = native.get_lib()\n"
        "print(lib._name if lib else None)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1 and outs[0].startswith(str(tmp_path))
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == [
        native.LIB_NAME]


class _FakeLib:
    """A library whose every function reports ABI version 999."""

    class _Fn:
        restype = None
        argtypes = None

        def __call__(self):
            return 999

    def __getattr__(self, name):
        return self._Fn()


def _no_compiler(mp, tmp):
    mp.setattr(native, "CXX", str(tmp / "no-such-g++"))


def _bad_source(mp, tmp):
    src = tmp / "bad.cpp"
    src.write_text("this is not C++\n")
    mp.setattr(native, "SOURCE", src)


def _corrupt_library(mp, tmp):
    bad = tmp / "libbad.so"
    bad.write_bytes(b"not an elf file")
    mp.setattr(native, "build", lambda: bad)


def _abi_mismatch(mp, tmp):
    mp.setattr(native.ctypes, "CDLL", lambda path: _FakeLib())


def _disabled(mp, tmp):
    mp.setenv("GS3D_DISABLE_NATIVE", "1")
    mp.setattr(native, "build", lambda: pytest.fail("built while disabled"))


@pytest.mark.parametrize("break_it", [_disabled, _no_compiler, _bad_source,
                                      _corrupt_library, _abi_mismatch],
                         ids=lambda f: f.__name__.strip("_"))
def test_loader_falls_back_to_numpy(break_it, monkeypatch, tmp_path):
    """Each failure gives None (the numpy path) without raising, and the
    answer is cached: a second call tries nothing."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    break_it(monkeypatch, tmp_path)
    assert native.get_lib() is None and not native.available()
    monkeypatch.delenv("GS3D_DISABLE_NATIVE", raising=False)
    monkeypatch.setattr(native, "build",
                        lambda: pytest.fail("loader tried again"))
    assert native.get_lib() is None
