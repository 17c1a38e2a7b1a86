"""Tile binning and the tile-scale work schedule.

The counterpart of ``wgpu_3dgs_core_tpu.ops.binning``: the one-level bbox
binning :func:`bin_splats` (K7 expansion, a stable (tile, depth) sort) and,
for the render path, exact two-level row-trimmed binning
(:func:`bin_splats_attrs`:
K1 row expansion, exact per-row tile intervals, K2 fragment expansion,
one stable 1-key tile sort, ``searchsorted`` tile ranges) and the
tile-scale part of ``pad_schedule``, which keeps the JAX package's
capacity and overflow contract. The capacity dry pass
(:func:`count_capacities`) runs the same f32 arithmetic as the binning,
so it counts exactly what it emits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .expand import (
    EXPAND_BLOCK,
    ROW_GID,
    ROW_ROW,
    ROW_SPANX,
    ROW_X0,
    TAB_CNT,
    RowStream,
    _check_limits,
    _exclusive_cumsum,
    build_row_tables,
    build_segment_table,
    build_tables,
    expand_fragments,
    expand_fragments_with_attrs,
    expand_rows,
)

TILE_SIZE = 16

# Conservative widening (pixels) of the exact ellipse radii and per-row
# x-intervals: absorbs the f32 rounding of the interval arithmetic so a
# tile holding a blendable pixel is never culled by a last-bit error.
ROW_TRIM_EPS = 0.05

# Fragment block width of the JAX package's rasterizer schedule, and its
# blocks per grid step, as its ``render`` uses them: together they size
# the padded schedule whose truncation the port reproduces
# (:func:`pad_schedule`).
CHUNK = 128
GROUP = 8


class FragmentStream(NamedTuple):
    """Tile-sorted fragment stream, fixed capacity F_cap."""

    gauss_id: torch.Tensor  # [F_cap] int32, gaussian per fragment
    tile_id: torch.Tensor  # [F_cap] int32, == num_tiles for padding slots
    num_fragments: torch.Tensor  # 0-d int32
    overflow: torch.Tensor  # 0-d bool: true fragment/row count > capacity
    tile_start: torch.Tensor  # [num_tiles] int32
    tile_end: torch.Tensor  # [num_tiles] int32


class TileSchedule(NamedTuple):
    """Tile-scale part of the JAX package's tile-padded block schedule.

    The JAX rasterizer draws each tile in CHUNK-sized blocks, at most
    ``B_cap`` of them in all; a tile whose blocks fall past the cap is
    truncated or dropped. These fields reproduce exactly which fragments
    it draws, so the overflow flag and a truncated image agree with it.
    """

    tile_len: torch.Tensor  # [T] int32, fragments of the tile
    nblk: torch.Tensor  # [T] int32, CHUNK blocks the tile needs
    off_blk: torch.Tensor  # [T] int32, the tile's first block
    live_blocks: torch.Tensor  # 0-d int32, blocks within the cap
    tile_written: torch.Tensor  # [T] bool, tile drawn (else background)
    truncated: torch.Tensor  # 0-d bool, blocks exceeded the cap
    draw_len: torch.Tensor  # [T] int32, fragments the rasterizer draws


def num_tiles(width: int, height: int) -> tuple[int, int]:
    tx = -(-width // TILE_SIZE)
    ty = -(-height // TILE_SIZE)
    return tx, ty


def tile_bounds(xy, extent, tiles_x: int, tiles_y: int, tile_y_offset=0):
    """Per-gaussian tile bbox [x0, x1) x [y0, y1), clamped to the grid
    (int32). Upper bounds are floor(edge / TILE) + 1. ``tile_y_offset``
    shifts into the ``tiles_y``-row strip starting at that global tile
    row."""
    rx = extent[:, 0]
    ry = extent[:, 1]
    x0 = torch.clamp((xy[:, 0] - rx) / TILE_SIZE, 0, tiles_x).to(torch.int32)
    x1 = torch.clamp(
        torch.floor((xy[:, 0] + rx) / TILE_SIZE) + 1, 0, tiles_x
    ).to(torch.int32)
    y0g = torch.floor((xy[:, 1] - ry) / TILE_SIZE).to(torch.int32)
    y1g = (torch.floor((xy[:, 1] + ry) / TILE_SIZE) + 1).to(torch.int32)
    if tile_y_offset:  # the render path bins the whole grid: no ops added
        y0g, y1g = y0g - tile_y_offset, y1g - tile_y_offset
    y0 = torch.clamp(y0g, 0, tiles_y)
    y1 = torch.clamp(y1g, 0, tiles_y)
    return x0, y0, x1, y1


def _bbox_counts(xy, extent, mask, tiles_x, tiles_y, tile_y_offset):
    """(x0, y0, span_x, bbox fragment count) per gaussian."""
    x0, y0, x1, y1 = tile_bounds(xy, extent, tiles_x, tiles_y,
                                 tile_y_offset)
    span_x = torch.clamp_min(x1 - x0, 0)
    span_y = torch.clamp_min(y1 - y0, 0)
    live = mask & (extent[:, 0] > 0) & (extent[:, 1] > 0)
    return x0, y0, span_x, torch.where(live, span_x * span_y, 0)


def count_fragments(xy, extent, mask, tiles_x: int, tiles_y: int,
                    tile_y_offset=0) -> torch.Tensor:
    """Live fragment count of :func:`bin_splats` (bbox tiles), which
    sizes its ``max_fragments``."""
    return _bbox_counts(xy, extent, mask, tiles_x, tiles_y,
                        tile_y_offset)[3].sum()


def bbox_table(xy, extent, mask, tiles_x: int, tiles_y: int,
               tile_y_offset=0):
    """K7's input: the one-level table of every gaussian's bbox tiles (in
    original order) and its live fragment count, a 0-d int32 tensor."""
    x0, y0, span_x, counts = _bbox_counts(xy, extent, mask, tiles_x,
                                          tiles_y, tile_y_offset)
    counts = counts.to(torch.int32)
    gid = torch.arange(xy.shape[0], dtype=torch.int32, device=xy.device)
    table = build_segment_table(_exclusive_cumsum(counts), counts, span_x,
                                x0, y0, gid)
    return table, counts.sum(dtype=torch.int32)


def bin_splats(xy, extent, depth, mask, tiles_x: int, tiles_y: int,
               max_fragments: int, tile_y_offset=0) -> FragmentStream:
    """One-level binning: every gaussian into every tile of its bbox, a
    (tile, depth)-sorted stream of capacity ``max_fragments``.

    With ``tile_y_offset``, bins only the ``tiles_y``-row strip starting at
    that global tile row (local tile ids). K7 expands the table in
    original gaussian order; two stable sorts, by depth and then by tile,
    give the JAX package's stable 2-key (tile, depth) sort: ties go by
    slot, i.e. by gaussian id. Masked gaussians have depth +inf. torch's
    sort orders -0.0 and +0.0 as equal (ties by id) and NaN last, as
    ``lax.sort`` does; the JAX package's scenes have depth > 0. There is
    no ``expand_impl``: the device of the inputs is the only switch, and
    any capacity works.
    """
    n = xy.shape[0]
    _check_limits(n, tiles_x)
    dev = xy.device
    t_total = tiles_x * tiles_y
    depth_key = torch.where(mask, depth, float("inf"))
    table, total = bbox_table(xy, extent, mask, tiles_x, tiles_y,
                              tile_y_offset)
    tile, gid = expand_fragments(table, total, max_fragments, tiles_x,
                                 t_total)  # K7
    depth_frag = (depth_key[gid] if n else
                  torch.zeros(max_fragments, dtype=depth.dtype, device=dev))
    by_depth = torch.sort(depth_frag, stable=True).indices
    perm = by_depth[torch.sort(tile[by_depth], stable=True).indices]
    tile_sorted = tile[perm]
    tile_ids = torch.arange(t_total, dtype=torch.int32, device=dev)
    return FragmentStream(
        gauss_id=gid[perm],
        tile_id=tile_sorted,
        num_fragments=torch.clamp_max(total, max_fragments),
        overflow=total > max_fragments,
        tile_start=torch.searchsorted(tile_sorted, tile_ids, out_int32=True),
        tile_end=torch.searchsorted(tile_sorted, tile_ids, right=True,
                                    out_int32=True),
    )


def exact_radii(conic, op_eff, cutoff_sq, opacity_cull):
    """Exact half-extents (rx, ry) of the blend support {q <= Q},
    Q = min(cutoff_sq, 2 ln(255 op_eff)) (just cutoff_sq without
    ``opacity_cull``, as the ellipse display mode needs), widened by
    ROW_TRIM_EPS."""
    ca, cb_, cc = conic
    d = torch.clamp_min(ca * cc - cb_ * cb_, 0.0)
    if opacity_cull:
        q = torch.clamp(
            2.0 * torch.log(torch.clamp_min(255.0 * op_eff, 1e-12)),
            0.0, cutoff_sq,
        )
    else:
        q = torch.full_like(ca, cutoff_sq)
    inv_d = 1.0 / torch.clamp_min(d, 1e-20)
    rx = torch.sqrt(torch.clamp_min(q * cc * inv_d, 0.0))
    ry = torch.sqrt(torch.clamp_min(q * ca * inv_d, 0.0))
    eps = torch.where(q > 0.0, ROW_TRIM_EPS, 0.0)
    return rx + eps, ry + eps


def _row_tile_span(tx0_bbox, row, span_x, ry, cx, cy, ca, cb, cc):
    """Exact tile x-interval of the support ellipse within one tile row.

    Per-row f32 inputs: bbox first tile column, tile row, bbox
    tile width, support y half-extent, the gaussian's centre and conic.
    Returns (tx0, cnt) int32, clamped into the bbox (cnt >= 1 for any row
    inside it). The same f32 arithmetic as the JAX package.
    """
    a_safe = torch.clamp_min(ca, 1e-12)
    beta = cb / a_safe
    d = torch.clamp_min(ca * cc - cb * cb, 0.0)
    k = torch.sqrt(d) / a_safe
    dyg = cb * ry / torch.clamp_min(
        torch.sqrt(torch.clamp_min(ca * cc, 0.0)), 1e-12
    )

    y_px = row * TILE_SIZE
    d_lo = torch.clamp(y_px - cy, -ry, ry)
    d_hi = torch.clamp(y_px + TILE_SIZE - cy, -ry, ry)

    def width(dy):
        return k * torch.sqrt(torch.clamp_min(ry * ry - dy * dy, 0.0))

    c_max = torch.clamp(-dyg, d_lo, d_hi)
    c_min = torch.clamp(dyg, d_lo, d_hi)
    xmax = torch.maximum(
        torch.maximum(-beta * d_lo + width(d_lo), -beta * d_hi + width(d_hi)),
        -beta * c_max + width(c_max),
    )
    xmin = torch.minimum(
        torch.minimum(-beta * d_lo - width(d_lo), -beta * d_hi - width(d_hi)),
        -beta * c_min - width(c_min),
    )

    tx0 = torch.floor((cx + xmin - ROW_TRIM_EPS) / TILE_SIZE)
    tx1 = torch.floor((cx + xmax + ROW_TRIM_EPS) / TILE_SIZE) + 1.0
    tx0 = torch.clamp(tx0, tx0_bbox, tx0_bbox + span_x - 1.0)
    tx1 = torch.clamp(tx1, tx0 + 1.0, tx0_bbox + span_x)
    return tx0.to(torch.int32), (tx1 - tx0).to(torch.int32)


def _exact_bounds(xy, extent, conic, op_eff, mask, tiles_x, tiles_y,
                  cutoff_sq, opacity_cull):
    """Exact-support tile bounds: (x0, y0, x1, y1, span_x, span_y, live,
    ry_ex), the bbox of the support clamped into the extent's bbox."""
    rx_ex, ry_ex = exact_radii(
        (conic[:, 0], conic[:, 1], conic[:, 2]), op_eff, cutoff_sq,
        opacity_cull,
    )
    xb0, yb0, xb1, yb1 = tile_bounds(xy, extent, tiles_x, tiles_y)
    ex2 = torch.stack([rx_ex, ry_ex], dim=-1)
    xe0, ye0, xe1, ye1 = tile_bounds(xy, ex2, tiles_x, tiles_y)
    x0 = torch.clamp(xe0, xb0, xb1)
    x1 = torch.clamp(xe1, x0, xb1)
    y0 = torch.clamp(ye0, yb0, yb1)
    y1 = torch.clamp(ye1, y0, yb1)
    span_x = torch.clamp_min(x1 - x0, 0)
    span_y = torch.clamp_min(y1 - y0, 0)
    live = mask & (extent[:, 0] > 0) & (extent[:, 1] > 0)
    return x0, y0, x1, y1, span_x, span_y, live, ry_ex


def gaussian_table(xy, extent, depth, mask, attr_cols, tiles_x: int,
                   tiles_y: int, cutoff_sq: float = 9.0,
                   opacity_cull: bool = True):
    """Level 1 input: the depth-ordered per-gaussian table whose counts are
    the exact-support bbox row spans, with attribute rows ``attr_cols``
    then ry. Returns (table, total_rows as a 0-d int32 tensor)."""
    n = xy.shape[0]
    _check_limits(n, tiles_x)
    depth_key = torch.where(mask, depth, float("inf"))
    x0, y0, _, _, span_x, span_y, live, ry_ex = _exact_bounds(
        xy, extent, attr_cols[2:5].T, attr_cols[8], mask, tiles_x, tiles_y,
        cutoff_sq, opacity_cull,
    )
    # A row exists only when the bbox has nonzero width too; every emitted
    # row then intersects the support ellipse, so its interval is nonempty.
    row_counts = torch.where(live & (span_x > 0), span_y, 0).to(torch.int32)
    gid_src = torch.arange(n, dtype=torch.int32, device=xy.device)
    attr10 = torch.cat([attr_cols, ry_ex[None]], dim=0)
    table = build_tables(row_counts, span_x, x0, y0, gid_src, attr10,
                         depth_key)
    return table, row_counts.sum(dtype=torch.int32)


def row_table(rows: RowStream, total_rows):
    """Level 2 input: the per-row table of the row stream's exact tile
    intervals. Returns (table, total fragments as a 0-d int32 tensor)."""
    r_cap = rows.ints.shape[1]
    ra = rows.attrs  # the blend attributes, then ry
    live_r = torch.arange(r_cap, dtype=torch.int32,
                          device=ra.device) < total_rows
    tx0_r, cnt_r = _row_tile_span(
        rows.ints[ROW_X0].float(), rows.ints[ROW_ROW].float(),
        rows.ints[ROW_SPANX].float(), ra[-1], ra[0], ra[1], ra[2], ra[3],
        ra[4],
    )
    table = build_row_tables(cnt_r, tx0_r, rows.ints[ROW_ROW],
                             rows.ints[ROW_GID], ra[:-1], live_r)
    return table, table.ints[TAB_CNT].sum(dtype=torch.int32)


def row_capacity(max_rows: int) -> int:
    """Row-stream capacity, rounded up to EXPAND_BLOCK as in the JAX
    package so both flag the same row overflow."""
    return -(-max_rows // EXPAND_BLOCK) * EXPAND_BLOCK


def bin_splats_attrs(xy, extent, depth, mask, attr_cols, tiles_x: int,
                     tiles_y: int, max_fragments: int,
                     max_rows: int | None = None, cutoff_sq: float = 9.0,
                     opacity_cull: bool = True):
    """Two-level exact binning with the per-fragment attribute fetch.

    ``attr_cols``: [A, N] f32 per-gaussian attributes (x, y, conic a/b/c,
    r, g, b, opacity). Gaussians expand into their bbox tile rows (K1),
    each row into its exact tile interval (K2); the stream is emitted
    depth-major, so one stable sort by tile yields (tile, depth, id)
    blend order. ``max_rows`` bounds the row stream (default
    ``max_fragments``).

    Returns (stream, attrs_sorted [A + 1, F_cap] f32 with gid as the last
    row, the per-gaussian SegmentTable).
    """
    dev = xy.device
    a = attr_cols.shape[0]
    t_total = tiles_x * tiles_y
    table, total_rows = gaussian_table(
        xy, extent, depth, mask, attr_cols, tiles_x, tiles_y, cutoff_sq,
        opacity_cull,
    )
    r_cap = row_capacity(max_fragments if max_rows is None else max_rows)
    rows = expand_rows(table, total_rows, r_cap)  # K1
    rtab, total = row_table(rows, total_rows)
    tile, _, fetched = expand_fragments_with_attrs(  # K2
        rtab, total, max_fragments, tiles_x, t_total,
    )
    overflow = (total_rows > r_cap) | (total > max_fragments)

    # One stable 1-key sort by tile: the stream is depth-major already.
    # Padding slots carry tile == t_total and sort last.
    tile_sorted, perm = torch.sort(tile, stable=True)
    attrs_sorted = fetched[:, perm]

    tile_ids = torch.arange(t_total, dtype=torch.int32, device=dev)
    tile_start = torch.searchsorted(tile_sorted, tile_ids, out_int32=True)
    tile_end = torch.searchsorted(tile_sorted, tile_ids, right=True,
                                  out_int32=True)
    stream = FragmentStream(
        gauss_id=attrs_sorted[a].to(torch.int32),
        tile_id=tile_sorted,
        num_fragments=torch.clamp_max(total, max_fragments),
        overflow=overflow,
        tile_start=tile_start,
        tile_end=tile_end,
    )
    return stream, attrs_sorted, table


def padded_capacity(f_cap: int, t_total: int, pad_slack: float) -> int:
    """Slots of the JAX rasterizer's tile-padded schedule: the stream plus
    ``pad_slack`` of one partial block per tile, in whole groups."""
    grp = CHUNK * GROUP
    return -(-(f_cap + int(t_total * CHUNK * pad_slack)) // grp) * grp


def pad_schedule(stream: FragmentStream, f_pad_cap: int) -> TileSchedule:
    """Tile-scale part of the JAX package's padded block schedule.

    Each tile's fragments are padded up to whole ``CHUNK`` blocks; the
    blocks are laid out tile after tile, and only the first
    ``f_pad_cap // CHUNK`` exist. A tile whose first block lies past the
    cap is not drawn; one that straddles it is drawn up to the cap;
    either way ``truncated`` is set and the renderer folds it into
    ``overflow``.
    """
    if f_pad_cap % CHUNK:
        raise ValueError("f_pad_cap must be a multiple of CHUNK")
    b_cap = f_pad_cap // CHUNK
    ln = (stream.tile_end - stream.tile_start).to(torch.int32)
    nblk = torch.div(ln + CHUNK - 1, CHUNK, rounding_mode="floor")
    off_blk = torch.cumsum(nblk, 0, dtype=torch.int32) - nblk
    total_blocks = nblk.sum(dtype=torch.int32)
    live_blocks = torch.clamp_max(total_blocks, b_cap)
    draw_len = torch.clamp_min(
        torch.minimum(ln, (live_blocks - off_blk) * CHUNK), 0
    )
    return TileSchedule(
        tile_len=ln,
        nblk=nblk,
        off_blk=off_blk,
        live_blocks=live_blocks,
        tile_written=(ln > 0) & (off_blk < live_blocks),
        truncated=total_blocks > b_cap,
        draw_len=draw_len.to(torch.int32),
    )


def count_capacities(xy, extent, conic, op_eff, mask, tiles_x, tiles_y,
                     cutoff_sq: float = 9.0, opacity_cull: bool = True):
    """Exact live (gaussian, tile-row) and fragment counts of the stream
    :func:`bin_splats_attrs` emits with the same ``opacity_cull``, which
    size ``max_rows`` and ``max_fragments``: the same bounds and interval
    arithmetic on the same f32 values. Returns two 0-d int64 tensors;
    syncs with the device once, for the loop bound over tile rows."""
    x0, y0, _, _, span_x, span_y, live, ry_ex = _exact_bounds(
        xy, extent, conic, op_eff, mask, tiles_x, tiles_y, cutoff_sq,
        opacity_cull,
    )
    live = live & (span_x > 0)
    row_counts = torch.where(live, span_y, 0)
    rows = row_counts.sum()
    total = torch.zeros((), dtype=torch.int64, device=xy.device)
    max_span_y = int(row_counts.max()) if row_counts.numel() else 0
    for r in range(max_span_y):
        has = live & (r < span_y)
        _, cnt = _row_tile_span(
            x0.float(), (y0 + r).float(), span_x.float(), ry_ex,
            xy[:, 0], xy[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
        )
        total += torch.where(has, cnt, 0).sum()
    return rows, total


def default_max_fragments(n: int, tiles_x: int, tiles_y: int,
                          avg_overlap: float = 8.0) -> int:
    """Heuristic stream capacity, ``avg_overlap`` tiles per gaussian
    rounded up to a lane multiple. Prefer a measured capacity
    (render/renderer.py measure_capacities): the heuristic wastes work or
    overflows on scenes far from ``avg_overlap``."""
    cap = int(max(n * avg_overlap, 1024))
    cap = min(cap, n * tiles_x * tiles_y) if n else 1024
    return -(-cap // 256) * 256
