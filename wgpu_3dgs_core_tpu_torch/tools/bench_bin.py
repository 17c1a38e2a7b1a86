"""The binning chain by stage on the card.

The counterpart of ``tools/bench_bin.py``, on the port's
``ops/binning.py::bin_splats_attrs`` (two-level, row-trimmed): its
prefixes on one bench projection made outside the timer, each containing
the one before:

- ``counts``: the exact-support bounds (``_exact_bounds``) and the row
  counts, as ``gaussian_table`` begins;
- ``tables``: ``gaussian_table``, the depth-ordered per-gaussian table;
- ``rows``: + K1 (``expand_rows``) and ``row_table``, the rows' exact
  tile intervals;
- ``expand``: + K2 (``expand_fragments_with_attrs``);
- ``sort``: + the stable 1-key tile sort and the attribute gather;
- ``ranges``: + the ``searchsorted`` tile ranges and ``pad_schedule``.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_bin [bench arguments] \\
        [--iters 10] [--device cuda]

Prints a line per stage, then one JSON line naming the device
(``tools/stages.py``). Reads on a CUDA card only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.binning import (
    FragmentStream,
    _exact_bounds,
    gaussian_table,
    num_tiles,
    pad_schedule,
    padded_capacity,
    row_capacity,
    row_table,
)
from ..ops.expand import expand_fragments_with_attrs, expand_rows
from .stages import (
    CUTOFF_SQ,
    bench_parser,
    bench_setup,
    forward_prefix,
    read_stages,
    report,
    require_card,
    stream_capacity,
)

BIN_STAGES = ("counts", "tables", "rows", "expand", "sort", "ranges")


def projection(params, camera, sh_deg: int) -> dict:
    """The binning's inputs, made as ``render`` makes them (the
    ``color`` prefix of ``tools/stages.py::forward_prefix``): (xy,
    extent, depth, mask, attr_cols)."""
    pieces = forward_prefix(params, camera, 0, 0, 0.0, sh_deg, "color")
    s = pieces["splats"]
    return dict(xy=s.xy, extent=s.extent, depth=s.depth, mask=s.mask,
                attr_cols=pieces["attr_cols"])


@torch.no_grad()
def bin_prefix(proj: dict, tiles_x: int, tiles_y: int, max_fragments: int,
               max_rows: int, pad_slack: float, upto: str) -> dict:
    """``bin_splats_attrs`` (SPLAT mode) on ``proj`` up to and including
    the stage ``upto`` of BIN_STAGES, op for op, then ``pad_schedule``:
    the pieces made so far."""
    if upto not in BIN_STAGES:
        raise ValueError(f"upto {upto!r} is none of {BIN_STAGES}")
    xy, extent, depth, mask, attr_cols = (
        proj[k] for k in ("xy", "extent", "depth", "mask", "attr_cols"))
    if upto == "counts":
        depth_key = torch.where(mask, depth, float("inf"))
        _, _, _, _, span_x, span_y, live, _ = _exact_bounds(
            xy, extent, attr_cols[2:5].T, attr_cols[8], mask, tiles_x,
            tiles_y, CUTOFF_SQ, True)
        row_counts = torch.where(live & (span_x > 0), span_y,
                                 0).to(torch.int32)
        return dict(depth_key=depth_key, row_counts=row_counts,
                    total_rows=row_counts.sum(dtype=torch.int32))
    table, total_rows = gaussian_table(xy, extent, depth, mask, attr_cols,
                                       tiles_x, tiles_y, CUTOFF_SQ)
    out = dict(table=table, total_rows=total_rows)
    if upto == "tables":
        return out
    r_cap = row_capacity(max_rows)
    rows = expand_rows(table, total_rows, r_cap)  # K1
    rtab, total = row_table(rows, total_rows)
    out.update(rows=rows, row_table=rtab, total=total)
    if upto == "rows":
        return out
    t_total = tiles_x * tiles_y
    tile, _, fetched = expand_fragments_with_attrs(  # K2
        rtab, total, max_fragments, tiles_x, t_total)
    overflow = (total_rows > r_cap) | (total > max_fragments)
    out.update(tile=tile, fetched=fetched, overflow=overflow)
    if upto == "expand":
        return out
    tile_sorted, perm = torch.sort(tile, stable=True)
    attrs_sorted = fetched[:, perm]
    out.update(tile_sorted=tile_sorted, attrs_sorted=attrs_sorted)
    if upto == "sort":
        return out
    tile_ids = torch.arange(t_total, dtype=torch.int32, device=xy.device)
    stream = FragmentStream(
        gauss_id=attrs_sorted[attr_cols.shape[0]].to(torch.int32),
        tile_id=tile_sorted,
        num_fragments=torch.clamp_max(total, max_fragments),
        overflow=overflow,
        tile_start=torch.searchsorted(tile_sorted, tile_ids,
                                      out_int32=True),
        tile_end=torch.searchsorted(tile_sorted, tile_ids, right=True,
                                    out_int32=True),
    )
    sched = pad_schedule(stream,
                         padded_capacity(max_fragments, t_total, pad_slack))
    out.update(stream=stream, sched=sched,
               overflow=overflow | sched.truncated)
    return out


def stages(params, camera, max_fragments: int, max_rows: int,
           pad_slack: float, sh_deg: int) -> dict:
    """The prefixes of BIN_STAGES on one projection of ``params``, with
    ``render``'s capacities."""
    proj = projection(params, camera, sh_deg)
    tiles_x, tiles_y = num_tiles(camera.width, camera.height)
    args = (tiles_x, tiles_y, stream_capacity(max_fragments), max_rows,
            pad_slack)
    return {name: (lambda upto=name: bin_prefix(proj, *args, upto))
            for name in BIN_STAGES}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = require_card(args.device, "bench_bin")
    params, camera = bench_setup(args, dev)
    todo = stages(params, camera, args.max_fragments, args.max_rows,
                  args.pad_slack, args.sh_deg)
    return report("bench_bin", dev, args, read_stages(todo, args.iters))


if __name__ == "__main__":
    main()
