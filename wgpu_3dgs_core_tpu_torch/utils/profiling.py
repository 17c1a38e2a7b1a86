"""Tracing and profiling helpers.

The counterpart of ``wgpu_3dgs_core_tpu.utils.profiling``, with the same
names, on ``torch.profiler`` and CUDA events: a labelled region shows up
in a Chrome/Perfetto trace as the wgpu debug labels of the reference show
up in GPU debuggers. :func:`block_and_time` times on the device the
function's outputs lie on: CUDA events on the card, ``perf_counter`` on
the CPU.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Any, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

log = logging.getLogger(__name__)


def named_scope(name: str):
    """Label a region of host work and the kernels it launches."""
    return record_function(name)


def annotate(name: Optional[str] = None):
    """Decorator: wrap a function in a named profiler scope."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block (CPU ops, and CUDA kernels where a card is
    present) and write a Chrome trace into ``log_dir``. Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sum it by name."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def timed(label: str, results: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock a block (waits for the card only if the block does)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = dt
        log.info("%s: %.3f ms", label, dt * 1e3)


def device_name(device) -> str:
    """The name a measurement on ``device`` is reported under: the card's
    name, or "cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def device_kernel_ms(fn, *args, iters: int = 10, **kwargs):
    """Device kernel time per call of ``fn`` by torch.profiler, in ms: the
    kernels alone, without the host's pace between them. None where no
    device kernel ran."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args, **kwargs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters


def _first_tensor(out: Any) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def block_and_time(label: str, fn, *args, iters: int = 10, warmup: int = 2,
                   **kwargs) -> float:
    """Steady-state seconds per call of ``fn``. Where its output lies on a
    card, CUDA events around ``iters`` back-to-back calls (device time,
    the host's enqueue of the first call left out); otherwise the host's
    clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        with torch.cuda.device(t.device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args, **kwargs)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        dt = (time.perf_counter() - t0) / iters
    log.info("%s: %.3f ms/iter", label, dt * 1e3)
    return dt
