"""segsum_roofline.train: the least time of summing per-fragment
gradients per gaussian (benchmark/roofline.py: segsum) over the device
time of K5 (both kernels) and K6, in %."""

from benchmark import roofline as rl
from benchmark import trace as tr
from benchmark.kinds import kernel_kind


def read(ctx):
    s = tr.op_seconds(ctx["trace"].device_ops, lambda n: kernel_kind(n) in (
        "K5 prep", "K5 segment_sums", "K6 uncompact"))
    return rl.roofline_pct([rl.segsum(c) for c in ctx["work"]], s)
