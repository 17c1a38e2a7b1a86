"""raster_roofline.train: the least time of the forward blend and its
backward (benchmark/roofline.py: k3, k4) over K3's and K4's device
time, in %."""

from benchmark import roofline as rl
from benchmark import trace as tr
from benchmark.kinds import kernel_kind


def read(ctx):
    s = tr.op_seconds(ctx["trace"].device_ops, lambda n: kernel_kind(n) in (
        "K3 rasterize_fwd", "K4 rasterize_bwd"))
    work = [w for c in ctx["work"] for w in (rl.k3(c), rl.k4(c))]
    return rl.roofline_pct(work, s)
