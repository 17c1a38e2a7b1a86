"""Segment tables that K7's merge-path design finds hard.

K7 (``ops/expand.py::expand_fragments``) gives each block a fixed stretch
of the merge of a table's row offsets with the output slots
(``ops/expand.py::MERGE_ITEMS`` steps). :func:`hard_tables` makes tables
that stress that partition: long runs of rows with no slots across
several blocks, one row owning more slots than a block takes, no slot at
all, a capacity every slot of which is live, a capacity that is not a
multiple of a block, and the bench scene's table shape at 1/16 scale. The
CPU tests hold the partition's mirror to ``searchsorted`` on them, and
the card tests and ``chip_smoke.py`` hold K7 to its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.expand import TAB_ROWS, SegmentTable, build_segment_table

HARD_TABLES = ("zero_runs", "wide_row", "no_slot", "full", "ragged_cap",
               "bench_1_16")
# The bench camera's tile grid (1920x1080 in 16-pixel tiles).
TILES_X, TILES_Y = 120, 68


def _table(rng, counts: np.ndarray) -> SegmentTable:
    """A table over ``counts`` in the given row order (rows with no slot
    stay where they are, at their successor's offset)."""
    n = counts.shape[0]
    off = np.cumsum(counts) - counts
    ints = np.stack([
        off, counts, rng.integers(1, 9, n), rng.integers(0, TILES_X, n),
        rng.integers(0, TILES_Y, n), rng.permutation(n),
    ]).astype(np.int32)
    assert ints.shape[0] == TAB_ROWS
    return SegmentTable(torch.from_numpy(ints),
                        torch.zeros((0, n), dtype=torch.float32))


def _bench_like(rng, n: int) -> tuple[SegmentTable, int]:
    """The bench scene's one-level table shape: about 3 slots a gaussian
    from bbox spans of 1-3 tiles each way, 3% of gaussians culled (count
    0, compacted to the tail by build_segment_table)."""
    span_x, span_y = (rng.choice([1, 2, 3], n, p=[0.45, 0.4, 0.15])
                      for _ in range(2))
    counts = np.where(rng.random(n) < 0.03, 0, span_x * span_y)
    counts = torch.from_numpy(counts.astype(np.int32))
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    table = build_segment_table(
        offsets, counts, torch.from_numpy(span_x),
        torch.from_numpy(rng.integers(0, TILES_X, n)),
        torch.from_numpy(rng.integers(0, TILES_Y, n)),
        torch.arange(n, dtype=torch.int32))
    return table, int(counts.sum())


def hard_tables(device="cpu"):
    """{name: (table, total, cap, tiles_x, t_total)}, K7's arguments, for
    each name of :data:`HARD_TABLES`, drawn from fixed seeds."""
    out = {}
    for i, name in enumerate(HARD_TABLES):
        rng = np.random.default_rng(100 + i)
        if name == "bench_1_16":
            table, total = _bench_like(rng, 1_000_000 // 16)
            cap = -(-(3 * total) // 1024) * 512  # x 1.5, up to 512
        else:
            if name == "zero_runs":
                counts = rng.integers(1, 7, 20_000)
                counts[:300] = 0  # slot 0 owned past the first rows
                for start in (1_000, 6_000, 13_000):  # runs over 2-3 blocks
                    counts[start:start + rng.integers(4_000, 6_000)] = 0
            elif name == "wide_row":
                counts = rng.integers(0, 5, 3_000)
                counts[1_500] = 10_000  # about five blocks of slots
            elif name == "no_slot":
                counts = np.zeros(5_000, np.int64)
            else:
                counts = rng.integers(0, 6, 9_000)
            table = _table(rng, counts)
            total = int(counts.sum())
            cap = {"full": total, "no_slot": 4_096}.get(name, total + 777)
        t = torch.tensor(total, dtype=torch.int32)
        out[name] = (SegmentTable(table.ints.to(device),
                                  table.attrs.to(device)), t.to(device),
                     cap, TILES_X, TILES_X * TILES_Y)
    return out
