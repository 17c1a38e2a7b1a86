"""Fragment expansion: kernels K1 (rows), K2 (fragments) and K7 (bbox).

The counterpart of ``wgpu_3dgs_core_tpu.ops.expand``. A segment table
gives each of its rows a run of output slots; expansion writes, for every
slot, the owning row's fields and the slot's rank in the run:

- K1, :func:`expand_rows` (replaces ``_expand_row_kernel``): gaussians ->
  (gaussian, bbox tile row) entries, over the per-gaussian table whose
  counts are the bbox row spans. The render path runs its row-table form,
  ``binning.expand_row_table``, which also computes each row's exact tile
  interval and writes the per-row table K2 reads.
- K2, :func:`expand_fragments_with_attrs` (replaces
  ``_expand_attr_kernel``): tile rows -> fragments (tile id, gaussian id,
  attributes), over the per-row table (span == count). The render path
  runs its record form, :func:`expand_fragment_records`, which writes
  each slot's attributes and gid as one 48-B record for
  ``binning.sorted_fetch`` (K14).
- K7, :func:`expand_fragments` (replaces ``_expand_kernel``): the
  one-level expansion of ``binning.bin_splats``: gaussians -> (tile id,
  gaussian id) over their whole tile bbox, K2 without attributes, over the
  per-gaussian table of :func:`build_segment_table` (original order).

Tables are native: int32 columns and an f32 attribute table, built by
:func:`build_tables` / :func:`build_row_tables` /
:func:`build_segment_table`. The TPU's base-256 digit
rows and bf16 splits are not carried over. On CUDA tensors the wrappers
launch ``csrc/expand.cu``; on CPU tensors they run the plain versions
(``searchsorted`` + gathers), which the kernels equal bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda import CudaKernel, I, P, check, on_cpu

# Capacity granule kept from the JAX package: row capacities round up to
# it, so both packages size (and flag overflow of) the same row stream.
EXPAND_BLOCK = 512

# Segment table int rows (csrc/common.cuh GS_TAB_*).
TAB_OFF = 0  # exclusive slot offset of the row's run (emission order)
TAB_CNT = 1  # run length (0 on the tail past the live rows)
TAB_SPAN = 2  # bbox tile width, >= 1 (rank -> (dy, dx) decode)
TAB_X0 = 3  # first tile column
TAB_Y0 = 4  # first (strip-local) tile row
TAB_GID = 5  # original gaussian index
TAB_ROWS = 6

# K1 row-stream int rows (csrc/expand.cu kRow*). Its float rows are the
# table's attribute rows: the 9 blend attributes, then ry.
ROW_X0 = 0
ROW_ROW = 1  # strip-local tile row: y0 + rank
ROW_SPANX = 2
ROW_GID = 3
ROW_INTS = 4

# K2's record form (csrc/expand.cu kRecord*): a [f_cap, RECORD_WIDTH] f32
# row a slot, the RECORD_ATTRS blend attributes, the gid's int32 bits at
# RECORD_GID, then zeros (48 B, 16-B aligned).
RECORD_ATTRS = 9
RECORD_GID = 9
RECORD_WIDTH = 12


class SegmentTable(NamedTuple):
    """Row i owns output slots [off[i], off[i] + cnt[i])."""

    ints: torch.Tensor  # [TAB_ROWS, n] int32
    attrs: torch.Tensor  # [A, n] f32


class RowStream(NamedTuple):
    """K1 output: one column per (gaussian, bbox tile row) slot."""

    ints: torch.Tensor  # [ROW_INTS, r_cap] int32, zero past the live rows
    attrs: torch.Tensor  # [A, r_cap] f32, zero past the live rows


def _check_limits(n, tiles_x=None):
    # The JAX package's input limits, kept so both packages accept the
    # same inputs.
    if n >= (1 << 24):
        raise ValueError("expand kernel requires N < 2^24 (f32-exact ids)")
    if tiles_x is not None and tiles_x >= 256:
        raise ValueError(
            "expand kernel requires tiles_x < 256; render wider images in "
            "horizontal strips"
        )


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32) - x


def build_tables(counts, span_x, x0, y0, gid, attr_rows,
                 depth) -> SegmentTable:
    """Compact the per-gaussian table in DEPTH order.

    A stable sort by (count == 0, depth): gaussians with slots first, in
    ascending depth, ties by original index (the reference renderer's
    stable depth order), so expansion emits depth-major and the fragment
    sort needs only the tile key. Offsets are the exclusive cumsum of the
    sorted counts; tail rows (count 0) get zero attributes.
    """
    n = counts.shape[0]
    _check_limits(n)
    by_depth = torch.sort(depth, stable=True).indices
    empty = (counts[by_depth] == 0).to(torch.int32)
    order = by_depth[torch.sort(empty, stable=True).indices]
    n_live = (counts > 0).sum()
    tail = torch.arange(n, device=counts.device) >= n_live
    cnt = torch.where(tail, 0, counts[order]).to(torch.int32)
    ints = torch.stack([
        _exclusive_cumsum(cnt),
        cnt,
        *(c[order].to(torch.int32)
          for c in (torch.clamp_min(span_x, 1), x0, y0, gid)),
    ])
    attrs = torch.where(tail[None, :], 0.0, attr_rows[:, order])
    return SegmentTable(ints.contiguous(), attrs.contiguous())


def build_row_tables(cnt_r, tx0_r, row_r, gid_r, attr9,
                     live_r) -> SegmentTable:
    """Per-row table for level-2 expansion, elementwise at row scale.

    The row stream is already depth-major and every live row owns >= 1
    fragment, so no sort is needed. span == count: the level-2 rank
    decode becomes dy = 0, dx = rank. Rows where ``live_r`` is false get
    count 0 and zero fields.
    """
    cnt = torch.where(live_r, cnt_r, 0).to(torch.int32)
    zero = torch.zeros_like(cnt)
    ints = torch.stack([
        _exclusive_cumsum(cnt),
        cnt,
        torch.clamp_min(cnt, 1),
        torch.where(live_r, tx0_r.to(torch.int32), zero),
        torch.where(live_r, row_r.to(torch.int32), zero),
        torch.where(live_r, gid_r.to(torch.int32), zero),
    ])
    attrs = torch.where(live_r[None, :], attr9, 0.0)
    return SegmentTable(ints.contiguous(), attrs.contiguous())


def _owner(table: SegmentTable, cap: int, total: torch.Tensor):
    """Plain owner search: (slot live?, owner row, rank in the run)."""
    dev = table.ints.device
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    live = slot < total
    off = table.ints[TAB_OFF].contiguous()
    n = off.shape[0]
    g = torch.searchsorted(off, slot, right=True) - 1
    g = torch.clamp(g, 0, max(n - 1, 0))
    rank = slot - off[g]
    return live, g, rank


def check_table(table: SegmentTable, total: torch.Tensor) -> None:
    n = table.ints.shape[1]
    check(table.ints, "table.ints", torch.int32, (TAB_ROWS, n))
    check(table.attrs, "table.attrs", torch.float32, (None, n))
    check(total, "total", torch.int32, ())


# -------------------------------------------------------------------- K1


def expand_rows_plain(table: SegmentTable, total_rows: torch.Tensor,
                      r_cap: int) -> RowStream:
    """Plain version of K1 (the spec the kernel equals bit for bit)."""
    a = table.attrs.shape[0]
    dev = table.ints.device
    if table.ints.shape[1] == 0:
        return RowStream(
            torch.zeros((ROW_INTS, r_cap), dtype=torch.int32, device=dev),
            torch.zeros((a, r_cap), dtype=torch.float32, device=dev),
        )
    live, g, rank = _owner(table, r_cap, total_rows)
    t = table.ints[:, g]
    ints = torch.stack([
        t[TAB_X0], t[TAB_Y0] + rank, t[TAB_SPAN], t[TAB_GID],
    ])
    ints = torch.where(live[None, :], ints, 0).to(torch.int32)
    attrs = torch.where(live[None, :], table.attrs[:, g], 0.0)
    return RowStream(ints, attrs)


EXPAND_ROWS = CudaKernel(
    "expand_rows", "gs_expand_rows", [P, P, I, I, P, I, P, P],
)


def expand_rows(table: SegmentTable, total_rows: torch.Tensor,
                r_cap: int) -> RowStream:
    """K1: expand the per-gaussian table (counts = bbox row spans) into the
    row stream. ``total_rows`` is a 0-d int32 tensor on the table's device;
    slots at or past it are zero."""
    check_table(table, total_rows)
    if on_cpu(table.ints, table.attrs, total_rows):
        return expand_rows_plain(table, total_rows, r_cap)
    a, n = table.attrs.shape
    dev = table.ints.device
    ints = torch.empty((ROW_INTS, r_cap), dtype=torch.int32, device=dev)
    attrs = torch.empty((a, r_cap), dtype=torch.float32, device=dev)
    EXPAND_ROWS.launch(
        table.ints.data_ptr(), table.attrs.data_ptr(), n, a,
        total_rows.data_ptr(), r_cap, ints.data_ptr(), attrs.data_ptr(),
        work=r_cap, device=dev,
    )
    return RowStream(ints, attrs)


# -------------------------------------------------------------------- K2


def empty_tiles(cap: int, t_total: int, dev):
    return (torch.full((cap,), t_total, dtype=torch.int32, device=dev),
            torch.zeros((cap,), dtype=torch.int32, device=dev))


def _slot_tiles(table: SegmentTable, total: torch.Tensor, cap: int,
                tiles_x: int, t_total: int):
    """The decode K2 and K7 share: (slot live?, owner row, tile, gid) of
    every slot; tile = (y0 + dy) * tiles_x + x0 + dx with (dy, dx) =
    divmod(rank, span). Slots at or past ``total`` get (t_total, 0)."""
    live, g, rank = _owner(table, cap, total)
    t = table.ints[:, g]
    span = torch.clamp_min(t[TAB_SPAN], 1)
    dy = torch.div(rank, span, rounding_mode="floor")
    dx = rank - dy * span
    tile = (t[TAB_Y0] + dy) * tiles_x + t[TAB_X0] + dx
    tile = torch.where(live, tile, t_total).to(torch.int32)
    gid = torch.where(live, t[TAB_GID], 0).to(torch.int32)
    return live, g, tile, gid


def expand_fragments_with_attrs_plain(table: SegmentTable,
                                      total: torch.Tensor, f_cap: int,
                                      tiles_x: int, t_total: int):
    """Plain version of K2 (the spec the kernel equals bit for bit)."""
    a = table.attrs.shape[0]
    dev = table.ints.device
    if table.ints.shape[1] == 0:
        tile, gid = empty_tiles(f_cap, t_total, dev)
        return tile, gid, torch.zeros((a + 1, f_cap), dtype=torch.float32,
                                      device=dev)
    live, g, tile, gid = _slot_tiles(table, total, f_cap, tiles_x, t_total)
    attrs = torch.where(live[None, :], table.attrs[:, g], 0.0)
    attrs = torch.cat([attrs, gid.to(torch.float32)[None, :]], dim=0)
    return tile, gid, attrs


EXPAND_FRAGMENTS = CudaKernel(
    "expand_fragments", "gs_expand_fragments",
    [P, P, I, I, P, I, I, I, P, P],
)


def expand_fragments_with_attrs(table: SegmentTable, total: torch.Tensor,
                                f_cap: int, tiles_x: int, t_total: int):
    """K2: expand a segment table into fragments.

    Returns (tile [f_cap] int32, gid [f_cap] int32, attrs [A + 1, f_cap]
    f32) in emission (depth-major) order: tile = (y0 + dy) * tiles_x +
    x0 + dx with (dy, dx) = divmod(rank, span); attrs are the owner's
    attributes and then gid as f32. Slots at or past ``total`` get
    tile = t_total, gid 0 and zero attributes.
    """
    check_table(table, total)
    if on_cpu(table.ints, table.attrs, total):
        return expand_fragments_with_attrs_plain(table, total, f_cap,
                                                 tiles_x, t_total)
    a, n = table.attrs.shape
    dev = table.ints.device
    ints = torch.empty((2, f_cap), dtype=torch.int32, device=dev)
    attrs = torch.empty((a + 1, f_cap), dtype=torch.float32, device=dev)
    EXPAND_FRAGMENTS.launch(
        table.ints.data_ptr(), table.attrs.data_ptr(), n, a,
        total.data_ptr(), f_cap, tiles_x, t_total, ints.data_ptr(),
        attrs.data_ptr(), work=f_cap, device=dev,
    )
    return ints[0], ints[1], attrs


def expand_fragment_records_plain(table: SegmentTable, total: torch.Tensor,
                                  f_cap: int, tiles_x: int, t_total: int):
    """Plain version of K2's record form (the spec the kernel equals bit
    for bit): :func:`expand_fragments_with_attrs_plain`'s attribute rows
    transposed, the gid's int32 bits, zeros."""
    tile, gid, attrs = expand_fragments_with_attrs_plain(
        table, total, f_cap, tiles_x, t_total)
    rec = torch.zeros((f_cap, RECORD_WIDTH), dtype=torch.float32,
                      device=tile.device)
    rec[:, :RECORD_ATTRS] = attrs[:RECORD_ATTRS].T
    rec[:, RECORD_GID] = gid.view(torch.float32)
    return tile, rec


EXPAND_RECORDS = CudaKernel(
    "expand_fragment_records", "gs_expand_fragment_records",
    [P, P, I, P, I, I, I, P, P],
)


def expand_fragment_records(table: SegmentTable, total: torch.Tensor,
                            f_cap: int, tiles_x: int, t_total: int):
    """K2's record form, the render path's K2: the per-row table (9 blend
    attribute rows) into ``tile`` [f_cap] int32, as
    :func:`expand_fragments_with_attrs` gives it, and ``records``
    [f_cap, RECORD_WIDTH] f32, one a slot (RECORD_*). Slots at or past
    ``total`` get tile = t_total and a zero record."""
    check_table(table, total)
    if table.attrs.shape[0] != RECORD_ATTRS:
        raise ValueError(f"the record form carries {RECORD_ATTRS} attribute "
                         f"rows, got {table.attrs.shape[0]}")
    if on_cpu(table.ints, table.attrs, total):
        return expand_fragment_records_plain(table, total, f_cap, tiles_x,
                                             t_total)
    n = table.ints.shape[1]
    dev = table.ints.device
    tile = torch.empty((f_cap,), dtype=torch.int32, device=dev)
    rec = torch.empty((f_cap, RECORD_WIDTH), dtype=torch.float32,
                      device=dev)
    EXPAND_RECORDS.launch(
        table.ints.data_ptr(), table.attrs.data_ptr(), n, total.data_ptr(),
        f_cap, tiles_x, t_total, tile.data_ptr(), rec.data_ptr(),
        work=f_cap, device=dev,
    )
    return tile, rec


# -------------------------------------------------------------------- K7


def build_segment_table(offsets, counts, span_x, x0, y0, gid) -> SegmentTable:
    """The one-level table of :func:`expand_fragments`, in ORIGINAL
    gaussian order: the gaussians with a nonzero count first (a stable
    sort of count == 0 compacts them in order), each with its exclusive
    slot offset (``offsets``), then tail rows of count 0 at offset
    ``total``. Native int32 columns and no attributes: the JAX package's
    bf16 digit rows and pad guard columns are not carried over."""
    n = counts.shape[0]
    _check_limits(n)
    dev = counts.device
    order = torch.sort((counts == 0).to(torch.int32), stable=True).indices
    cnt = counts[order].to(torch.int32)
    tail = cnt == 0
    total = counts.sum(dtype=torch.int32)
    ints = torch.stack([
        torch.where(tail, total, offsets[order].to(torch.int32)),
        cnt,
        *(c[order].to(torch.int32)
          for c in (torch.clamp_min(span_x, 1), x0, y0, gid)),
    ])
    attrs = torch.zeros((0, n), dtype=torch.float32, device=dev)
    return SegmentTable(ints.contiguous(), attrs)


def expand_fragments_plain(table: SegmentTable, total: torch.Tensor,
                           f_cap: int, tiles_x: int, t_total: int):
    """Plain version of K7 (the spec the kernel equals bit for bit)."""
    if table.ints.shape[1] == 0:
        return empty_tiles(f_cap, t_total, table.ints.device)
    _, _, tile, gid = _slot_tiles(table, total, f_cap, tiles_x, t_total)
    return tile, gid


# Merge steps a block of K7 takes (csrc/expand.cu kMergeItems).
MERGE_ITEMS = 2048


def merge_path_partition_plain(off: torch.Tensor, cap: int,
                               items: int = MERGE_ITEMS):
    """Where K7's blocks start, as the kernel finds it: block b takes
    steps [b * items, (b + 1) * items) of the merge of the row offsets
    ``off`` (int32 [n], nondecreasing) with the slots [0, cap), a row
    before a slot when its offset is <= the slot. Returns (slot, row)
    int64 [blocks + 1]: the slots and rows taken before each block, then
    (cap, n). The kernel searches with 32 probes a round, this mirror by
    halving; the predicate, and so the result, is the same."""
    n = off.shape[0]
    blocks = -(-(n + cap) // items)
    d = torch.clamp(torch.arange(blocks + 1, device=off.device) * items,
                    max=n + cap)
    lo = torch.clamp(d - cap, min=0)
    hi = torch.clamp(d, max=n)
    off64 = off.long()
    while bool((lo < hi).any()):
        open_ = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        before = off64[torch.clamp(mid, max=max(n - 1, 0))] <= d - 1 - mid
        lo = torch.where(open_ & before, mid + 1, lo)
        hi = torch.where(open_ & ~before, mid, hi)
    return d - lo, lo


EXPAND_BBOX = CudaKernel(
    "expand_fragments_bbox", "gs_expand_bbox", [P, I, P, I, I, I, P],
)


def expand_fragments(table: SegmentTable, total: torch.Tensor, f_cap: int,
                     tiles_x: int, t_total: int):
    """K7: expand the one-level table into ``tile`` and ``gid`` [f_cap]
    int32, in original gaussian order; slots at or past ``total`` (a 0-d
    int32 tensor on the table's device) get tile = t_total and gid 0. On
    the card each block takes a stretch of the merge of the offsets with
    the slots (:func:`merge_path_partition_plain`)."""
    check_table(table, total)
    if on_cpu(table.ints, table.attrs, total):
        return expand_fragments_plain(table, total, f_cap, tiles_x, t_total)
    n = table.ints.shape[1]
    dev = table.ints.device
    out = torch.empty((2, f_cap), dtype=torch.int32, device=dev)
    EXPAND_BBOX.launch(
        table.ints.data_ptr(), n, total.data_ptr(), f_cap, tiles_x, t_total,
        out.data_ptr(), work=f_cap, device=dev,
    )
    return out[0], out[1]
