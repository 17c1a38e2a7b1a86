"""frame_mfu.view: float32 operations a frame needs
(benchmark/roofline.py: frame_flops, the mean over the traced frames'
views) over the measured window's seconds per frame times the float32
peak, in %."""

from benchmark import roofline as rl


def read(ctx):
    if not ctx["trace"].device_ops or ctx["iter_s"] <= 0:
        return None
    flops = sum(rl.frame_flops(c) for c in ctx["work"]) / len(ctx["work"])
    return 100.0 * flops / (ctx["iter_s"] * rl.PEAK_FLOPS)
