"""autograd_ms.train: device ms per step of the self time of the
program's span ``train.step``: what no stage span inside it holds, the
loss and the autograd backward through the attribute columns, SH colour,
projection and ``constrained()`` (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "train.step")
