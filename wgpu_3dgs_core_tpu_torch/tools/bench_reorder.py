"""Two ways to put fragment attributes in (tile, depth) order, on the card.

The counterpart of ``tools/bench_reorder.py``: the rasterizer needs each
fragment's attributes in (tile, depth) order, either carried through
the sort as payloads or gathered afterwards from the per-gaussian table
by ``gid``. At its sizes (F fragments, N gaussians) it reads:

- ``sort2 + m f32 payloads`` for m in (1, 3, 6, 10): the stable 2-key
  (int32 tile, f32 depth) sort with m payload rows, in the port's idiom
  (``bench_sort_shapes.sort_payloads``);
- ``rowgather [F,9]``: ``table[gid, :9]``;
- ``rowgather [F,9] -> [9,F]``: the same rows written attribute-major, as
  the renderer holds them;
- ``rowgather [F,16] -> [16,F]``: all 16 columns, attribute-major;
- ``int gather 1 col``: ``depth[gid]``;
- ``scatter-add9 [F]->[N,9]``: the gather's backward,
  ``zeros(N, 9).index_add_(0, gid, rows[:9].T)`` from [16, F] rows.

The inputs are drawn with ``np.random.default_rng(0)`` in the JAX tool's
order (:func:`draw`) and moved to the device, ``gid`` also as int64 and
the payloads stacked, before any stage is read (:func:`inputs`). A JAX
transpose that XLA materialises is a contiguous copy here, and the JAX
tool's sums over strided slices have no counterpart: eager torch drops
no work.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_reorder \\
        [--fragments 4194304] [--gaussians 1000000] [--iters 8] \\
        [--device cuda]

Prints a line per stage, then one JSON line naming the device
(``tools/stages.py``). Reads on a CUDA card only.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from .bench_sort_shapes import sort_payloads
from .stages import read_stages, report, require_card

PAYLOADS = (1, 3, 6, 10)  # payload rows of the sort stages
TILE_KEYS = 8160


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fragments", type=int, default=4_194_304)
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


def draw(f: int, n: int) -> dict:
    """The JAX tool's draws, in its order, as numpy arrays; the 10
    payload columns stacked [10, F]."""
    rng = np.random.default_rng(0)
    out = {}
    out["key"] = rng.integers(0, TILE_KEYS, f, dtype=np.int32)
    out["depth"] = rng.random(f, dtype=np.float32)
    out["gid"] = rng.integers(0, n, f, dtype=np.int32)
    out["table"] = rng.random((n, 16), dtype=np.float32)
    out["cols"] = np.stack([rng.random(f, dtype=np.float32)
                            for _ in range(10)])
    out["rows9"] = rng.random((16, f), dtype=np.float32)
    return out


def inputs(arrays: dict, device) -> dict:
    """The draws as tensors on ``device``; ``gid`` also int64."""
    x = {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}
    x["gid_idx"] = x["gid"].long()
    return x


def stages(x: dict) -> dict:
    """The stages on the tensors of :func:`inputs`, by the JAX tool's
    labels."""
    key, depth, gid, table = x["key"], x["depth"], x["gid_idx"], x["table"]
    n = table.shape[0]
    out = {f"sort2 + {m} f32 payloads":
           (lambda m=m: sort_payloads(key, x["cols"][:m], second=depth))
           for m in PAYLOADS}
    out.update({
        "rowgather [F,9]": lambda: table[gid, :9],
        "rowgather [F,9] -> [9,F]": lambda: table[gid, :9].T.contiguous(),
        "rowgather [F,16] -> [16,F]": lambda: table[gid].T.contiguous(),
        "int gather 1 col": lambda: depth[gid],
        "scatter-add9 [F]->[N,9]": lambda: torch.zeros(
            (n, 9), device=table.device).index_add_(0, gid,
                                                     x["rows9"][:9].T),
    })
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
    dev = require_card(args.device, "bench_reorder")
    todo = stages(inputs(draw(args.fragments, args.gaussians), dev))
    return report("bench_reorder", dev, args, read_stages(todo, args.iters))


if __name__ == "__main__":
    main()
