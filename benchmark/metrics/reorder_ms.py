"""reorder_ms.train: device ms per step of the self time of the
program's span ``render.reorder``: the backward's slot sort by gaussian,
the gid column, K5, K6 and the overflow mask (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "render.reorder")
