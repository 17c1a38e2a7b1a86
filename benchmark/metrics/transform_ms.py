"""transform_ms.<loop>: device ms per iteration of the parameters'
transform into render arguments: the self time of the program's span
``train.constrain`` (``constrained()``: quaternion normalisation, the
covariance, the sigmoids) in training, ``render.unpack`` (the packed
layout's unpack) in viewing; from the traced block's host-traced part
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "train.constrain", "render.unpack")
