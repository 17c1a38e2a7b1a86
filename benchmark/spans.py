"""Device time by the program's stage spans, from the traced block.

The port opens a named scope at each stage of its training step and its
viewer frame (``SPANS``). The profiler records them only where it traces
the host's operations, so they are read from the traced block's second
part (``Trace.host_ops`` and ``Trace.gap_ops``, on one clock). On the
device the profiler projects a scope only onto the operations launched
directly inside it on its own thread, which leaves out its children's and
every backward operation the autograd thread launches; so each device
operation is given the host span that launched it instead. One stream runs
its operations in the order the host launched them: the k-th launch call of
a kind (a kernel, a copy, a fill) after the first span opened is the k-th
device operation of that kind, and the operation belongs to the innermost
span open on the host at that call, on whichever thread. Where the counts
of a kind differ, the launches cannot be matched and nothing is read.

A span's self time is the device time of the operations it holds that no
span inside it holds, in ms per iteration; an iteration is one ``ITER``
span. The names are a frozen copy of the program's, so that a change to the
program cannot change what a metric reads.
"""

from __future__ import annotations

import bisect
import collections
from typing import NamedTuple, Optional

SPANS = ("train.step", "train.constrain", "train.adam", "render.unpack",
         "render.project", "render.bin", "render.raster", "render.bin_bwd",
         "render.reorder")
# The span that opens once an iteration, by loop kind.
ITER = {"train": "train.step", "view": "render.unpack"}
# Host calls that put an operation on the device, by the operation's kind.
LAUNCHES = (("copy", ("cudaMemcpy", "cuMemcpy")),
            ("fill", ("cudaMemset", "cuMemset")),
            ("kernel", ("cudaLaunch", "cuLaunch")))
NO_SPAN = "no span"


class Split(NamedTuple):
    """Device ms per iteration: each span's self time (every span the
    block opened, 0 where it held nothing), the operations no span holds,
    and all operations; and the iterations read."""

    self_ms: dict
    no_span_ms: float
    total_ms: float
    iters: int

    @property
    def no_span_share(self) -> float:
        return self.no_span_ms / self.total_ms if self.total_ms else 0.0


def op_kind(name: str) -> str:
    """The kind of a device operation by its name."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def launch_kind(name: str) -> Optional[str]:
    """The kind of operation a host call launches, or None."""
    for kind, prefixes in LAUNCHES:
        if name.startswith(prefixes):
            return kind
    return None


def host_spans(trace) -> list:
    """The program's spans on the host, (name, start us, end us), in
    start order."""
    return [h for h in trace.host_ops if h[0] in SPANS]


class _Innermost:
    """The innermost span open at each time of a rising sequence: of the
    spans open, the latest-started."""

    def __init__(self, spans):
        self.spans = spans
        self.starts = [s[1] for s in spans]
        self.open: list = []
        self.next = 0

    def at(self, t: float) -> Optional[str]:
        nxt = bisect.bisect_right(self.starts, t, lo=self.next)
        self.open.extend(self.spans[self.next:nxt])
        self.next = nxt
        self.open = [s for s in self.open if s[2] >= t]
        return max(self.open, key=lambda s: s[1])[0] if self.open else None


def launch_spans(trace, spans) -> Optional[list]:
    """The innermost span (or None) of each operation of
    ``trace.gap_ops``, in its order; None where launches and operations
    cannot be matched."""
    t0 = spans[0][1]
    calls = collections.defaultdict(list)
    for name, s, _ in trace.host_ops:
        kind = launch_kind(name)
        if kind and s >= t0:
            calls[kind].append(s)
    ops = collections.defaultdict(list)
    for i, (name, _, _) in enumerate(trace.gap_ops):
        ops[op_kind(name)].append(i)
    if any(len(calls[k]) != len(ops[k]) for k in set(calls) | set(ops)):
        return None
    at = [None] * len(trace.gap_ops)
    for kind, idx in ops.items():
        for i, t in zip(idx, calls[kind]):
            at[i] = t
    order = sorted(range(len(at)), key=lambda i: at[i])
    inner = _Innermost(spans)
    owner = [None] * len(at)
    for i in order:
        owner[i] = inner.at(at[i])
    return owner


def stage_split(trace, kind: str) -> Optional[Split]:
    """The block's device time by span (see the module's docstring), or
    None where the program opened no span or the launches do not match."""
    spans = host_spans(trace)
    iters = sum(1 for s in spans if s[0] == ITER.get(kind))
    if not iters or not trace.gap_ops:
        return None
    owner = launch_spans(trace, spans)
    if owner is None:
        return None
    ms = dict.fromkeys({s[0] for s in spans}, 0.0)
    none = 0.0
    for (_, s, e), who in zip(trace.gap_ops, owner):
        if who is None:
            none += (e - s) / 1e3 / iters
        else:
            ms[who] += (e - s) / 1e3 / iters
    return Split(ms, none, sum(ms.values()) + none, iters)


def self_ms(ctx, train: str, view: Optional[str] = None) -> Optional[float]:
    """A reader's value: the self ms per iteration of span ``train`` in a
    training cell, of ``view`` in a viewer cell; None where it is absent."""
    name = train if ctx["kind"] == "train" else view
    split = stage_split(ctx["trace"], ctx["kind"]) if name else None
    return None if split is None else split.self_ms.get(name)


def idle_by_span(trace) -> list:
    """[[span, seconds], ...]: the device's idle gaps between consecutive
    operations of the traced block's second part, summed by the innermost
    program span open on the host at each gap's middle, largest first."""
    spans = host_spans(trace)
    gaps, end = [], None
    for _, s, e in trace.gap_ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    inner = _Innermost(spans)
    by = collections.defaultdict(float)
    for g0, g1 in gaps:
        by[inner.at((g0 + g1) / 2) or NO_SPAN] += (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]
