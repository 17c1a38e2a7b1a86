"""step_mfu.train: float32 operations a training step needs
(benchmark/roofline.py: train_step_flops, the mean over the traced
steps' views) over the measured window's seconds per step times the
float32 peak, in %."""

from benchmark import roofline as rl


def read(ctx):
    if not ctx["trace"].device_ops or ctx["iter_s"] <= 0:
        return None
    flops = sum(rl.train_step_flops(c) for c in ctx["work"]) / len(ctx["work"])
    return 100.0 * flops / (ctx["iter_s"] * rl.PEAK_FLOPS)
