"""Tracing and profiling helpers.

The counterpart of ``wgpu_3dgs_core_tpu.utils.profiling``, with the same
names, on ``torch.profiler`` and CUDA events: a labelled region shows up
in a Chrome/Perfetto trace as the wgpu debug labels of the reference show
up in GPU debuggers. :func:`block_and_time` times on the device the
function's outputs lie on: CUDA events on the card, ``perf_counter`` on
the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import os
import statistics
import time
from typing import Any, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

log = logging.getLogger(__name__)

# The kernel torch.cuda._sleep launches: the marker between profiled calls.
MARKER = "spin_kernel"
# A profiled session's markers before the calls, its pause at each end in
# seconds, and the sessions made before device_calls gives up (see there).
PROFILE_LEAD = 4
PROFILE_PAD_S = 0.25
PROFILE_TRIES = 3
# What the profiled sessions of this process met: sessions, markers lost,
# sessions with no device operation, sessions that kept a call short.
PROFILER_STATS: collections.Counter = collections.Counter()
# Device operations by kind: (kind, substring of the operation's name), the
# first match wins.
KERNEL_KINDS = (
    ("K3 rasterize_fwd", "rasterize_fwd_kernel"),
    ("K4 rasterize_bwd", "rasterize_bwd_kernel"),
    ("K5 prep", "segment_sums_prep_kernel"),
    ("K5 segment_sums", "segment_sums_kernel"),
    ("K6 uncompact", "uncompact_kernel"),
    ("K2 expand_fragments", "expand_fragments_kernel"),
    ("K1 expand_rows", "expand_rows_kernel"),
    ("K12 sh_color", "sh_color_"),
    ("K14 sorted_fetch", "sorted_fetch_kernel"),
    ("radix sort", "RadixSort"),
    ("cat/stack", "CatArray"),
    ("index/gather", "index"),
    ("reduce/scan", "reduce"),
    ("reduce/scan", "Scan"),
    ("copy/fill", "Memcpy"),
    ("copy/fill", "Memset"),
    ("NCCL collectives", "nccl"),
    ("elementwise", "elementwise"),
)


# What a scope is while no profiler records: one shared context that does
# nothing (a record_function costs a dispatcher round trip even then).
_NO_SCOPE = contextlib.nullcontext()


def named_scope(name: str):
    """Label a region of host work and the kernels it launches; the
    shared null context while no profiler records."""
    if not torch.autograd._profiler_enabled():
        return _NO_SCOPE
    return record_function(name)


def annotate(name: Optional[str] = None):
    """Decorator: wrap a function in a named profiler scope."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with named_scope(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


class Counts:
    """The values :func:`count` recorded in one :func:`counting` session,
    in call order: (name, 0-d tensor or host number)."""

    def __init__(self):
        self.values: list = []

    def totals(self) -> tuple[dict, dict]:
        """({name: sum}, {name: calls}). The device values are stacked and
        read once (one sync per device); nothing is read before."""
        sums: dict = collections.defaultdict(int)
        calls: collections.Counter = collections.Counter()
        on_device: dict = collections.defaultdict(list)
        for name, v in self.values:
            calls[name] += 1
            if isinstance(v, torch.Tensor):
                on_device[v.device].append((name, v))
            else:
                sums[name] += v
        for pairs in on_device.values():
            read = torch.stack([v.reshape(()).double()
                                for _, v in pairs]).tolist()
            for (name, v), x in zip(pairs, read):
                sums[name] += x if v.is_floating_point() else int(x)
        return dict(sums), dict(calls)


# The open counting session, if any.
_COUNTS: Optional[Counts] = None


@contextlib.contextmanager
def counting() -> Iterator[Counts]:
    """Open a session that keeps what :func:`count` records in the block;
    yields its :class:`Counts`. Kept in memory only."""
    global _COUNTS
    outer, _COUNTS = _COUNTS, Counts()
    try:
        yield _COUNTS
    finally:
        _COUNTS = outer


def count(name: str, value) -> None:
    """Record ``value`` (a 0-d tensor the program already computed, or a
    host number) under ``name`` in the open session; without one, nothing.
    Launches no kernel and never syncs."""
    if _COUNTS is not None:
        _COUNTS.values.append((name, value))


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


def split_calls(ops) -> list:
    """The device operations of a profiled session, by call: ``ops`` are
    profiler events in the order they ran, a marker kernel before each
    call and after the last. Empty groups (the lead-in's markers, a call
    whose every operation was lost) are left out."""
    calls, call = [], None
    for e in ops:
        if MARKER in e.name:
            if call:
                calls.append(call)
            call = []
        elif call is not None:
            call.append(e)
    return calls


def modal_calls(calls) -> list:
    """The calls with the most common number of device operations: a call
    that lost an operation from the trace has fewer."""
    sizes = collections.Counter(len(c) for c in calls)
    if not sizes:
        return []
    per = sizes.most_common(1)[0][0]
    return [c for c in calls if len(c) == per]


def _profiled_session(fn, args, kwargs, iters: int) -> list:
    """One torch.profiler session over ``iters`` back-to-back calls, each
    after a marker; the device operations of each call (split_calls)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        for _ in range(iters):
            torch.cuda._sleep(1)
            fn(*args, **kwargs)
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    # A named scope the profiler projects onto the device's timeline is no
    # device operation.
    ops = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    PROFILER_STATS["sessions"] += 1
    PROFILER_STATS["markers lost"] += (PROFILE_LEAD + iters + 1
                                       - sum(MARKER in e.name for e in ops))
    PROFILER_STATS["sessions with no device operation"] += not ops
    return split_calls(ops)


def device_calls(fn, *args, iters: int = 10, **kwargs) -> list:
    """The device operations (kernels, copies, fills) of each of ``iters``
    back-to-back calls of ``fn`` by torch.profiler: a list of calls, each
    a list of profiler events, every call with the same count.

    On an H100 this profiler loses the first two device operations of a
    session in most sessions, and shifts a session's device timestamps
    against its window by up to tenths of a second, so that a short
    session can lose them all. So a session begins with PROFILE_LEAD
    marker kernels, pauses PROFILE_PAD_S at each end, and is made again
    (up to PROFILE_TRIES in all) until every call keeps the same count of
    operations. Raises where no session keeps that for half the calls."""
    best: list = []
    for _ in range(PROFILE_TRIES):
        calls = modal_calls(_profiled_session(fn, args, kwargs, iters))
        if len(calls) == iters:
            return calls
        PROFILER_STATS["short sessions"] += 1
        if len(calls) > len(best):
            best = calls
    if 2 * len(best) < iters:
        raise RuntimeError(
            f"torch.profiler kept {len(best)} of {iters} calls whole in "
            f"{PROFILE_TRIES} sessions")
    return best


def kernel_kind(name: str) -> str:
    """The KERNEL_KINDS kind of a device operation's name, else "other"."""
    for kind, key in KERNEL_KINDS:
        if key in name:
            return kind
    return "other"


def kind_ms(calls) -> dict:
    """Device ms a call by kernel kind, largest first: the mean over
    ``calls`` (device_calls' output) of each kind's summed time."""
    by_kind: dict = collections.defaultdict(float)
    for e in (e for call in calls for e in call):
        by_kind[kernel_kind(e.name)] += e.time_range.elapsed_us()
    return {k: v / 1e3 / len(calls) for k, v in
            sorted(by_kind.items(), key=lambda kv: -kv[1])}


def host_pace_ms(fn, *args, iters: int = 10, **kwargs) -> tuple:
    """(host enqueue, wall) ms a call of ``fn`` over ``iters`` back-to-back
    calls, the card synchronised before and once after: equal when the
    host paces the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3 / iters, (t2 - t0) * 1e3 / iters


def device_kernel_ms(fn, *args, iters: int = 10, **kwargs) -> float:
    """Device time of one call of ``fn`` by torch.profiler, in ms: the
    median over ``iters`` back-to-back calls of the device operations
    each launches (device_calls), without the host's pace between them."""
    return statistics.median(
        sum(e.time_range.elapsed_us() for e in call)
        for call in device_calls(fn, *args, iters=iters, **kwargs)) / 1e3


def kernel_ms(label: str, fn, *args, iters: int = 10, warmup: int = 2,
              **kwargs) -> float:
    """Milliseconds a call of ``fn``: where its output lies on a card, its
    device time (device_kernel_ms, after ``warmup`` calls); otherwise the
    host's clock (block_and_time)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        with torch.cuda.device(t.device):
            ms = device_kernel_ms(fn, *args, iters=iters, **kwargs)
        log.info("%s: %.4f device ms", label, ms)
        return ms
    return block_and_time(label, fn, *args, iters=iters, warmup=0,
                          **kwargs) * 1e3


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
