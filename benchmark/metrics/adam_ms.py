"""adam_ms.train: device ms per step of the self time of the program's
span ``train.adam``: the optimizer's zero_grad and step
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "train.adam")
