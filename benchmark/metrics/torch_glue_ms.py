"""torch_glue_ms.<loop>: device ms per iteration of every operation that
is not one of the port's hand kernels (benchmark/kinds.py)."""

from benchmark import trace as tr
from benchmark.kinds import is_hand_kernel


def read(ctx):
    t = ctx["trace"]
    if not t.device_ops:
        return None
    glue = tr.op_seconds(t.device_ops, lambda n: not is_hand_kernel(n))
    return 1e3 * glue / t.iters
