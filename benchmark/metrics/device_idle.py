"""device_idle.<loop>: the share of an iteration of the measured window
in which no operation ran on the device, in %: 1 - (the traced block's
busy device seconds per iteration, the union of its operations'
intervals) / (the window's seconds per iteration). The window is
untraced: tracing costs the host some microseconds a launch, which
slows a host-paced loop by half again."""

from benchmark import trace as tr


def read(ctx):
    t = ctx["trace"]
    if not t.device_ops or ctx["iter_s"] <= 0:
        return None
    busy = tr.busy_seconds(t.device_ops) / t.iters
    return 100.0 * (1.0 - busy / ctx["iter_s"])
