"""project_ms.<loop>: device ms per iteration of the self time of the
program's span ``render.project``: the projection and the SH colour,
forward (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "render.project", "render.project")
