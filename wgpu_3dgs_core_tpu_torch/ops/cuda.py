"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled on first use by ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and linked into
one shared library with a plain C interface, loaded through ``ctypes``.
The library lands in ``_build/<key>/`` inside the package, keyed by a hash
of the sources and the compiler flags, so a checkout builds once and
rebuilds only when a source changes. Nothing here runs at import:
importing the package needs neither ``nvcc`` nor a card.

Each kernel entry point is a :class:`CudaKernel`, a :class:`Launcher`
bound to its symbol. A launcher counts its own launches, so a run can
show that it went through the kernel, and raises if the C side reports a
CUDA error for the launch.

Kernel bundles (ops/kernel_bundle.py) generate one small source per
dispatch signature; :func:`build_sources` compiles such sources, each into
its own library under ``_build/bundles/<key>/``, keyed by a hash of the
source, the headers it includes and the flags, all ``nvcc`` runs started
together. With ``relocatable=True`` it builds a source that launches
kernels from the device (``csrc/probe_dyngrid.cu``) the same way, with
``-rdc=true`` and a device link against cudadevrt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = (
    "expand.cu", "rasterize.cu", "segreduce.cu", "sh.cu", "variants.cu",
)
HEADERS = ("common.cuh", "blend.cuh", "rasterize_fwd.cuh", "segsum.cuh")
BUNDLE_HEADERS = ("common.cuh", "bundle.cuh", "gaussian.cuh")
BUNDLE_DIR = BUILD_DIR / "bundles"
BUNDLE_LIB = "libgs_bundle.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libgs_kernels.so"
# A source that launches kernels from the device (dynamic parallelism) is
# compiled relocatable and device-linked against cudadevrt, in a library
# of its own, so the other libraries keep their whole-program build.
RDC_FLAGS = ("-rdc=true",)
DEVRT = "-lcudadevrt"


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
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
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


def bundle_key(source: str, relocatable: bool = False) -> str:
    """The disk-cache key of a generated bundle source: everything that
    changes what nvcc builds from it, and nothing else."""
    h = hashlib.sha256(source.encode())
    for name in BUNDLE_HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if relocatable:
        h.update(" ".join((*RDC_FLAGS, DEVRT)).encode())
    return h.hexdigest()[:16]


def _nvcc_shared(cu: Path, lib: Path, relocatable: bool) -> list[str]:
    """The command that builds ``cu`` into the shared library ``lib``: one
    nvcc, or for a relocatable source a compile, a device link against
    cudadevrt and the host link, chained in one shell."""
    nvcc = find_nvcc()
    if not relocatable:
        return [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC_DIR), "-o",
                str(lib), str(cu)]
    obj, dlink = lib.with_suffix(".o"), lib.with_suffix(".dlink.o")
    steps = [
        [nvcc, *NVCC_FLAGS, *RDC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
         str(obj), str(cu)],
        [nvcc, *ARCH_FLAGS, "-Xcompiler", "-fPIC", "-dlink", "-o",
         str(dlink), str(obj), DEVRT],
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), str(obj), str(dlink),
         DEVRT],
    ]
    return ["sh", "-c", " && ".join(map(shlex.join, steps))]


def build_sources(sources: Sequence[str],
                  relocatable: bool = False) -> list[BuildInfo]:
    """Build each generated CUDA source into its own shared library (with
    ``-I csrc/``), reusing the ones this checkout has built; the missing
    ones are compiled by one nvcc each, all started together. Returns one
    BuildInfo per source, in order; ``seconds`` is the wall time of the
    concurrent builds (0 for a reused library). ``relocatable`` builds
    sources that launch kernels from the device (see RDC_FLAGS)."""
    infos: dict[str, BuildInfo] = {}
    jobs = []
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    for src in dict.fromkeys(sources):
        out_dir = BUNDLE_DIR / bundle_key(src, relocatable)
        lib = out_dir / BUNDLE_LIB
        log_path = out_dir / "nvcc.log"
        if lib.is_file():
            log = log_path.read_text() if log_path.is_file() else ""
            infos[src] = BuildInfo(lib, 0.0, log)
            continue
        cmd = _nvcc_shared(out_dir / "bundle.cu",
                           out_dir / f"{BUNDLE_LIB}.{tag}", relocatable)
        out_dir.mkdir(parents=True, exist_ok=True)
        cu = out_dir / "bundle.cu"
        cu_tmp = out_dir / f"bundle.cu.{tag}"
        cu_tmp.write_text(src)
        os.replace(cu_tmp, cu)
        tmp = out_dir / f"{BUNDLE_LIB}.{tag}"
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, proc, tmp, lib, log_path))
    logs = [proc.communicate()[0] for _, proc, *_ in jobs]  # wait for all
    for (src, proc, tmp, lib, log_path), log in zip(jobs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {lib.parent / 'bundle.cu'}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib)  # atomic, as in build()
        infos[src] = BuildInfo(lib, time.perf_counter() - t0, log)
    return [infos[src] for src in sources]


_library: ctypes.CDLL | None = None
_bundle_libraries: dict[Path, ctypes.CDLL] = {}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, once per process)."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build().path))
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def bundle_library(path: Path) -> ctypes.CDLL:
    """A built bundle library, loaded once per process."""
    lib = _bundle_libraries.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        _bundle_libraries[path] = lib
    return lib


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong


def bind(lib: ctypes.CDLL, symbol: str, argtypes: list):
    """The C entry ``symbol`` of ``lib``, typed; the stream comes last."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes) + [P]
    fn.restype = ctypes.c_int
    return fn


class Launcher:
    """A kernel's name in :func:`launch_counts` and its launch count."""

    registry: list["Launcher"] = []

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        Launcher.registry.append(self)

    def call(self, fn, lib: ctypes.CDLL, *args, work: int,
             device: torch.device) -> None:
        """Launch the bound C entry ``fn`` of ``lib`` over ``work`` output
        slots on ``device``'s current stream, with ``device`` current (made
        so only where another card is); every pointer argument is a
        tensor's ``data_ptr()``. With no work there is no grid: nothing is
        launched and nothing counted."""
        if work <= 0:
            return
        index = device.index
        if torch.cuda.current_device() == index:
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(device):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            msg = lib.gs_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


class CudaKernel(Launcher):
    """One C entry point of the kernel library and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        super().__init__(name)
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None

    def launch(self, *args, work: int, device: torch.device) -> None:
        """:meth:`Launcher.call` of this entry of the kernel library."""
        if self._fn is None:
            self._fn = bind(library(), self.symbol, self.argtypes)
        self.call(self._fn, library(), *args, work=work, device=device)


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in Launcher.registry}


def reset_launch_counts() -> None:
    for k in Launcher.registry:
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
