"""Block gathers, unique scatters, segment sums, an N-scale argsort and a
cumsum, on the card.

The counterpart of ``tools/bench_reorder2.py``, at its sizes (F
fragments, N gaussians, windows of K = ``--chunk`` slots, B = F / K of
them):

- ``blockgather``: B windows of [16, K] from the [16, F] rows at sorted
  starts, written [B, 16, K] (the sorted-to-padded repack);
- ``uniqset9``: ``z[perm] = rows`` of [F, 9] onto zeros; ``perm`` is a
  permutation, so the JAX tool's ``mode="drop"`` drops nothing;
- ``segsum9``: what ``jax.ops.segment_sum`` of [F, 9] rows by sorted ids
  into N segments computes, from the ids and the rows alone:
  ``torch.segment_reduce`` with each segment's length counted from the
  ids in the stage. It is the library call of PERF.md's K5 row;
- ``argsortN``: ``torch.argsort(depth, stable=True)`` at N;
- ``cumsum9``: ``torch.cumsum`` of [F, 9] along F.

The inputs are drawn with ``np.random.default_rng(0)`` in the JAX tool's
order (:func:`draw`) and moved to the device, the index columns also as
int64, before any stage is read (:func:`inputs`). The JAX tool's sums
over strided slices have no counterpart: eager torch drops no work.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_reorder2 \\
        [--fragments 4194304] [--gaussians 1000000] [--chunk 128] \\
        [--iters 8] [--device cuda]

Prints a line per stage, then one JSON line naming the device
(``tools/stages.py``). Reads on a CUDA card only.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from .stages import read_stages, report, require_card


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fragments", type=int, default=4_194_304)
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


def draw(f: int, n: int, k: int) -> dict:
    """The JAX tool's draws, in its order, as numpy arrays."""
    rng = np.random.default_rng(0)
    out = {}
    out["rows16"] = rng.random((16, f), dtype=np.float32)
    out["rows9f"] = rng.random((f, 9), dtype=np.float32)
    out["src_base"] = np.sort(rng.integers(0, f - k, f // k)).astype(
        np.int32)
    out["perm"] = rng.permutation(f).astype(np.int32)
    out["gid_sorted"] = np.sort(rng.integers(0, n, f)).astype(np.int32)
    out["depth"] = rng.random(n, dtype=np.float32)
    return out


def inputs(arrays: dict, device) -> dict:
    """The draws as tensors on ``device``; the starts and ``perm`` also
    int64 (``*_idx``), and the segment ids 0..N-1 whose lengths
    ``segsum9`` counts."""
    x = {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}
    for k in ("src_base", "perm"):
        x[k + "_idx"] = x[k].long()
    x["seg_ids"] = torch.arange(x["depth"].shape[0], dtype=torch.int32,
                                device=device)
    return x


def stages(x: dict, k: int) -> dict:
    """The five stages on the tensors of :func:`inputs` (windows of ``k``
    slots), by the JAX tool's labels (``blockgather`` .. ``cumsum9`` in
    the module's docstring, in order)."""
    rows9f, gid = x["rows9f"], x["gid_sorted"]
    # Every window of k slots, as a view [F - k + 1, 16, k] of the rows:
    # blockgather gathers B of them in one copy.
    windows = x["rows16"].unfold(1, k, 1).transpose(0, 1)

    def uniqset9():
        z = torch.zeros_like(rows9f)
        z[x["perm_idx"]] = rows9f
        return z

    def segsum9():
        lengths = (torch.searchsorted(gid, x["seg_ids"], right=True)
                   - torch.searchsorted(gid, x["seg_ids"]))
        return torch.segment_reduce(rows9f, "sum", lengths=lengths, axis=0,
                                    unsafe=True)

    return {
        "blockgather [B,16,K] slices": lambda: windows[x["src_base_idx"]],
        "unique perm-scatter set9": uniqset9,
        "segment_sum9 (sorted ids)": segsum9,
        "argsort N=1M": lambda: torch.argsort(x["depth"], stable=True),
        "cumsum [F,9]": lambda: torch.cumsum(rows9f, 0),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
    dev = require_card(args.device, "bench_reorder2")
    todo = stages(inputs(draw(args.fragments, args.gaussians, args.chunk),
                         dev), args.chunk)
    return report("bench_reorder2", dev, args,
                  read_stages(todo, args.iters))


if __name__ == "__main__":
    main()
