"""k3_roofline.view: the least time of the forward blend
(benchmark/roofline.py: k3) over K3's device time, in %."""

from benchmark import roofline as rl
from benchmark import trace as tr
from benchmark.kinds import kernel_kind


def read(ctx):
    s = tr.op_seconds(ctx["trace"].device_ops,
                      lambda n: kernel_kind(n) == "K3 rasterize_fwd")
    return rl.roofline_pct([rl.k3(c) for c in ctx["work"]], s)
