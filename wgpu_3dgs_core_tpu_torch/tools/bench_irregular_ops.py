"""The fragment-scale irregular ops, one by one, on the card.

The counterpart of ``tools/bench_irregular_ops.py``: its eleven ops at
its sizes (F fragments, N gaussians, T tiles), each as the port writes
it:

- ``sort2``: stable sort of int32 keys, then a gather of ``gid`` by its
  permutation (the tile sort with one payload);
- ``sort1``: the sort alone;
- ``scatter``: permutation inversion, ``z[perm] = arange(F)`` onto zeros;
- ``gather_t``: the small-table gather ``tstart[tile]`` at F;
- ``rowgather``: ``attr[gid]`` of an [N, 9] table, written [9, F];
- ``scat_add9``: ``zeros(N, 9).index_add_(0, gid, d)``, colliding rows
  (the backward's attribute gradient);
- ``scat_set16``: a unique row set of [F, 16] rows, written [16, F];
- ``rowgath16``: ``wide[perm]``, a permutation row gather of [F, 16];
- ``gather_f``: ``gid[perm]``;
- ``scan_max``: ``torch.cummax(gid).values``, what the JAX tool's
  ``associative_scan(maximum)`` computes;
- ``ss2``: the tile ranges, ``searchsorted`` left and right of the T tile
  ids in the sorted tiles, as int32.

The inputs are drawn with ``np.random.default_rng(0)`` in the JAX tool's
order (:func:`draw`) and moved to the device, index columns also as
int64 and the arange of ``scatter`` made, before any stage is read
(:func:`inputs`), so each stage times its op alone. A JAX transpose
that XLA materialises is a contiguous copy here: a bare ``.T`` is a
view and would time nothing.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_irregular_ops \\
        [--f 3145728] [--n 1000000] [--tiles 8160] [--iters 8] \\
        [--device cuda]

Prints a line per op, then one JSON line naming the device
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
    ap.add_argument("--f", type=int, default=3_145_728)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--tiles", type=int, default=8160)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


def draw(f: int, n: int, t: int) -> dict:
    """The JAX tool's draws, in its order, as numpy arrays."""
    rng = np.random.default_rng(0)
    out = {}
    out["tile"] = np.sort(rng.integers(0, t, f)).astype(np.int32)
    out["gid"] = rng.integers(0, n, f).astype(np.int32)
    out["perm"] = rng.permutation(f).astype(np.int32)
    out["attr"] = rng.random((n, 9)).astype(np.float32)
    out["tstart"] = np.arange(t, dtype=np.int32)
    out["keys_u"] = rng.integers(0, t, f).astype(np.int32)
    out["drows"] = rng.random((f, 9)).astype(np.float32)
    out["wide"] = rng.random((f, 16)).astype(np.float32)
    return out


def inputs(arrays: dict, device) -> dict:
    """The draws as tensors on ``device``; the index columns also int64
    (``*_idx``), and the scatter's values."""
    x = {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}
    for k in ("tile", "gid", "perm"):
        x[k + "_idx"] = x[k].long()
    x["iota"] = torch.arange(x["perm"].shape[0], dtype=torch.int32,
                             device=device)
    return x


def stages(x: dict) -> dict:
    """The eleven ops on the tensors of :func:`inputs`, by the JAX tool's
    labels."""
    f, n = x["gid"].shape[0], x["attr"].shape[0]
    dev = x["gid"].device

    def sort2():
        keys, perm = torch.sort(x["keys_u"], stable=True)
        return keys, x["gid"][perm]

    def scatter():
        z = torch.zeros(f, dtype=torch.int32, device=dev)
        z[x["perm_idx"]] = x["iota"]
        return z

    def scat_add9():
        return torch.zeros((n, 9), device=dev).index_add_(
            0, x["gid_idx"], x["drows"])

    def scat_set16():
        z = torch.zeros((f, 16), device=dev)
        z[x["perm_idx"]] = x["wide"]
        return z.T.contiguous()

    def ss2():
        return (torch.searchsorted(x["tile"], x["tstart"], out_int32=True),
                torch.searchsorted(x["tile"], x["tstart"], right=True,
                                   out_int32=True))

    return {
        "sort2": sort2,
        "sort1": lambda: torch.sort(x["keys_u"], stable=True).values,
        "scatter": scatter,
        "gather_t": lambda: x["tstart"][x["tile_idx"]],
        "rowgather": lambda: x["attr"][x["gid_idx"]].T.contiguous(),
        "scat_add9": scat_add9,
        "scat_set16": scat_set16,
        "rowgath16": lambda: x["wide"][x["perm_idx"]],
        "gather_f": lambda: x["gid"][x["perm_idx"]],
        "scan_max": lambda: torch.cummax(x["gid"], 0).values,
        "ss2": ss2,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
    dev = require_card(args.device, "bench_irregular_ops")
    todo = stages(inputs(draw(args.f, args.n, args.tiles), dev))
    return report("bench_irregular_ops", dev, args,
                  read_stages(todo, args.iters))


if __name__ == "__main__":
    main()
