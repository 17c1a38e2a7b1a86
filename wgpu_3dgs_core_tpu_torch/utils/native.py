"""ctypes bindings for the native C++ SPZ codec library.

The API of ``wgpu_3dgs_core_tpu.utils.native``: :func:`get_lib`,
:func:`available`, ``MIN_NATIVE_N``, the ``GS3D_DISABLE_NATIVE`` switch,
the argument types and the ABI check. Every entry point has a numpy
fallback in models/spz.py, so the package works without a toolchain; the
C++ implements the same f32 numerics bit for bit (``-ffp-contract=off``
keeps the compiler from fusing a multiply and an add that numpy rounds
twice).

The port builds its own copy of the source, ``csrc/spz_codec.cpp``, with
``g++`` on first use into ``_build/spz/<key>/libspz_codec.so`` inside the
package, with the flags of the JAX package's ``csrc/build.sh`` (OpenMP
when it links). The key hashes the source, the flags and what
``-march=native`` means on this host, so a library built for another
CPU is never loaded. Concurrent builds each write a file of their own
and move it into place atomically.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "spz_codec.cpp"
BUILD_DIR = PACKAGE_DIR / "_build" / "spz"
LIB_NAME = "libspz_codec.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")
OPENMP_FLAGS = ("-fopenmp",)
ABI_VERSION = 1
BUILD_TIMEOUT_S = 120

_lib: Optional[ctypes.CDLL] = None
_tried = False

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_i32 = ctypes.c_int


def _run(args) -> subprocess.CompletedProcess:
    return subprocess.run(args, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S, check=False)


def build_key(flags) -> str:
    """The disk-cache key of one build: the source, the flags and the
    target options ``-march=native`` resolves to on this host."""
    target = _run([CXX, "-march=native", "-Q", "--help=target"])
    if target.returncode:
        raise OSError(f"{CXX} -march=native failed: {target.stderr}")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(target.stdout.encode())
    return h.hexdigest()[:16]


def _compile(flags) -> Optional[Path]:
    out_dir = BUILD_DIR / build_key(flags)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    proc = _run([CXX, *flags, str(SOURCE), "-o", str(tmp)])
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        log.debug("native codec build %s failed: %s", flags, proc.stderr)
        return None
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def build() -> Optional[Path]:
    """The built library (with OpenMP when it links, else
    single-threaded), or None when there is no compiler or it fails."""
    try:
        for flags in (CXX_FLAGS + OPENMP_FLAGS, CXX_FLAGS):
            lib = _compile(flags)
            if lib is not None:
                return lib
    except (OSError, subprocess.SubprocessError) as e:  # no g++, timeout
        log.debug("native codec build failed: %s", e)
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (numpy fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("GS3D_DISABLE_NATIVE"):
        return None
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        log.debug("native codec load failed: %s", e)
        return None

    lib.spz_decode_fixed24.argtypes = [_u8p, _i64, _i32, _f32p]
    lib.spz_encode_fixed24.argtypes = [_f32p, _i64, _i32, _u8p]
    lib.spz_decode_scales.argtypes = [_u8p, _i64, _f32p]
    lib.spz_encode_scales.argtypes = [_f32p, _i64, _u8p]
    lib.spz_decode_quat_first3.argtypes = [_u8p, _i64, _f32p]
    lib.spz_encode_quat_first3.argtypes = [_f32p, _i64, _u8p]
    lib.spz_decode_quat_smallest3.argtypes = [_u8p, _i64, _f32p]
    lib.spz_encode_quat_smallest3.argtypes = [_f32p, _i64, _u8p]
    lib.spz_decode_colors.argtypes = [_u8p, _i64, _u8p]
    lib.spz_encode_colors.argtypes = [_u8p, _i64, _u8p]
    lib.spz_decode_sh.argtypes = [_u8p, _i64, _f32p]
    lib.spz_encode_sh.argtypes = [_f32p, _i64, _i32, _u8p]
    lib.spz_codec_abi_version.restype = _i32
    if lib.spz_codec_abi_version() != ABI_VERSION:
        log.warning("native codec ABI mismatch; using numpy fallback")
        return None
    _lib = lib
    log.info("native SPZ codec loaded from %s", path)
    return _lib


# Threshold below which numpy is just as fast (call overhead dominates).
MIN_NATIVE_N = 4096


def available() -> bool:
    return get_lib() is not None
