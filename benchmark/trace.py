"""The traced block of a ``--trace 1`` run, and the arithmetic on it.

After the measured window, a run with ``--trace 1`` runs a fixed number
of further iterations of the same loop under ``torch.profiler``,
tracing device operations alone (host operations traced too would slow
a host-paced loop twofold), then a few more with the host's operations,
which serve only to name the device's idle gaps. The
card's profiler can lose a session's first device operations and shift
its device timestamps against the session by tenths of a second, so the
session opens with marker kernels and pauses at each end; the markers are
left out of every reading. The window's length is the host's clock over
the iterations (each ends synchronised); the device's busy time is the
union of the device operations' intervals, on the device's clock. Neither
needs the two clocks to agree.
"""

from __future__ import annotations

import bisect
import collections
import time
from dataclasses import dataclass, field

import torch

from .kinds import kernel_kind

MARKER = "spin_kernel"
LEAD_MARKERS = 4
PAD_S = 0.25
TOP = 10


@dataclass
class Trace:
    """Device operations (name, start us, end us) in start order of the
    traced iterations, their count and the host's seconds over them;
    and, from a short second block traced with the host's operations
    too, its device and host operations (``gap_ops``, ``host_ops``), which
    name the idle gaps alone."""

    device_ops: list
    host_ops: list
    iters: int
    window_s: float
    views: list = field(default_factory=list)
    gap_ops: list = field(default_factory=list)


def _profiled(iterate, iters: int, cuda: bool, host: bool):
    """(device ops, host ops, host seconds, views) of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    views = []
    with profile(activities=acts) as prof:
        if cuda:
            for _ in range(LEAD_MARKERS):
                torch.cuda._sleep(1)
        sync()
        time.sleep(PAD_S)
        t0 = time.perf_counter()
        for k in range(iters):
            views.append(iterate(k))
        sync()
        window_s = time.perf_counter() - t0
        time.sleep(PAD_S)
    dev, hst = [], []
    for e in prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # A host range the profiler projects onto the device's
            # timeline (an optimizer's step, a record_function) is no
            # device operation.
            if MARKER not in e.name and not getattr(
                    e, "is_user_annotation", False):
                dev.append(rng)
        else:
            hst.append(rng)
    dev.sort(key=lambda r: r[1])
    hst.sort(key=lambda r: r[1])
    return dev, hst, window_s, views


def traced_block(iterate, iters: int, gap_iters: int, device) -> Trace:
    """Run ``iterate(k)`` (which returns the view it rendered) ``iters``
    times under a profiler of device operations alone, whose cost to the
    host is small, then ``gap_iters`` times with the host's operations
    traced too, to name the idle gaps."""
    cuda = torch.device(device).type == "cuda"
    dev, _, window_s, views = _profiled(iterate, iters, cuda, host=False)
    gap_dev, host, _, _ = _profiled(iterate, gap_iters, cuda, host=True)
    return Trace(dev, host, iters, window_s, views, gap_dev)


def busy_seconds(ops) -> float:
    """Seconds covered by the union of the intervals of ``ops``."""
    total, end = 0.0, None
    for _, s, e in sorted(ops, key=lambda r: r[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def op_seconds(ops, keep=lambda name: True) -> float:
    """Summed device seconds of the operations whose name ``keep``
    takes."""
    return sum(e - s for n, s, e in ops if keep(n)) / 1e6


def top_device_ops(ops, n: int = TOP) -> list:
    """[[name, seconds], ...]: the operations that took most time, by
    name, largest first."""
    by = collections.defaultdict(float)
    for name, s, e in ops:
        by[name[:160]] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = TOP) -> list:
    """[[what the host ran, seconds], ...]: the device's idle gaps between
    consecutive operations of the second block, summed by the innermost
    host operation running at each gap's middle, largest first."""
    ops = trace.gap_ops
    gaps = []
    end = None
    for _, s, e in ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = trace.host_ops
    starts = [h[1] for h in host]
    by = collections.defaultdict(float)
    for g0, g1 in gaps[:2000]:
        mid = (g0 + g1) / 2
        hi = bisect.bisect_right(starts, mid)
        # The latest-starting host operation still running at mid.
        label = next((host[i][0] for i in range(hi - 1, max(hi - 400, 0) - 1,
                                                -1) if host[i][2] >= mid),
                     "no host operation")
        by[label[:160]] += (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def kind_seconds(ops) -> dict:
    """Device seconds by kind."""
    by = collections.defaultdict(float)
    for name, s, e in ops:
        by[kernel_kind(name)] += (e - s) / 1e6
    return dict(by)
