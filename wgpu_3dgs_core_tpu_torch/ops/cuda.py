"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled on first use by ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and linked into
one shared library with a plain C interface, loaded through ``ctypes``.
The library lands in ``_build/<key>/`` inside the package, keyed by a hash
of the sources and the compiler flags, so a checkout builds once and
rebuilds only when a source changes. Nothing here runs at import:
importing the package needs neither ``nvcc`` nor a card.

Each kernel entry point is a :class:`CudaKernel`. It counts its own
launches, so a run can show that it went through the kernel, and raises
if the C side reports a CUDA error for the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("expand.cu", "rasterize.cu", "segreduce.cu")
HEADERS = ("common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libgs_kernels.so"


@dataclass(frozen=True)
class BuildInfo:
    """Where the library is, how long its build took (0 if it was already
    built), and what nvcc printed (registers, shared memory, spills)."""

    path: Path
    seconds: float
    log: str


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of wgpu_3dgs_core_tpu_torch are "
        "built from source with the CUDA toolkit (set CUDA_HOME)"
    )


def build_key() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the library if this checkout has not built it yet."""
    out_dir = BUILD_DIR / build_key()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return BuildInfo(lib, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                          str(CSRC_DIR / src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    failed = [src for src, proc in zip(SOURCES, procs) if proc.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{proc.stdout}"
            f"{proc.stderr}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return BuildInfo(lib, seconds, log)


_library: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, once per process)."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build().path))
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class CudaKernel:
    """One C entry point of the kernel library and its launch count."""

    registry: list["CudaKernel"] = []

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        CudaKernel.registry.append(self)

    def launch(self, *args, work: int, device: torch.device) -> None:
        """Launch over ``work`` output slots on ``device``'s current
        stream, with ``device`` current; every pointer argument is a
        tensor's ``data_ptr()``. With no work there is no grid: nothing is
        launched and nothing counted."""
        if work <= 0:
            return
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes + [P]  # the stream comes last
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            msg = library().gs_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in CudaKernel.registry}


def reset_launch_counts() -> None:
    for k in CudaKernel.registry:
        k.launches = 0


def on_cpu(*tensors: torch.Tensor) -> bool:
    """The dispatch rule of every kernel wrapper: True if all tensors lie on
    the CPU (take the plain version), False if all lie on one CUDA device
    (launch the kernel); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        names = sorted(map(str, devices))
        raise ValueError(f"tensors on several devices: {names}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {device}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple) -> None:
    """Validate a kernel argument: dtype, shape (None = any) and layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(
            f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
