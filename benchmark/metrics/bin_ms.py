"""bin_ms.<loop>: device ms per iteration of the self time of the
program's span ``render.bin``: the attribute columns, K1, K2, the tile
sort and gathers, the tile ranges and the padded schedule
(benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "render.bin", "render.bin")
