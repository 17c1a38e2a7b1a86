"""What a sort charges for keys, payloads, stability and length, on the card.

The counterpart of ``tools/bench_sort_shapes.py``: its cases A-I, labels
and sizes, each the port's own idiom of a sort with payloads
(:func:`sort_payloads`): one ``torch.sort`` gives the permutation and the
stacked payload rows are gathered by it, as the tile sort does
(``ops/binning.py:343``); a (tile, depth) key is two stable passes, by
depth first, then by tile of that order, as the table's depth sort
(``ops/expand.py:98-100``) and ``ops/binning.py:166-167`` do. The cases
price the port's sorts: the tile sort (A-E), the gid sort of the
backward (``ops/segreduce.py:68``, F and G), the table's depth sort (H,
I) and the route sort (``parallel/sharded.py:161``, a 1-key sort as C).

- A: stable 2-key (int32, f32) sort with 10 payloads at F_FWD;
- B-E: stable and unstable 1-key sorts with 10, 4 and 1 payloads;
- F, G: unstable 1-key sort with 9 payloads at the two backward lengths;
- H, I: the N-scale table sort, 1 key and 25 payloads, 2 keys and 24.

The inputs are drawn with ``np.random.default_rng(0)`` in the JAX tool's
order (:func:`draw`) and moved to the device before any stage is read
(:func:`inputs`); each stage returns its sorted keys and payloads. The
JAX tool's sums over strided slices, which keep XLA from dropping
payloads, have no counterpart: eager torch drops nothing.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_sort_shapes \\
        [--iters 10] [--device cuda]

Prints a line per case, then one JSON line naming the device
(``tools/stages.py``). Reads on a CUDA card only.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from .stages import read_stages, report, require_card

F_FWD = 3_276_800       # bench headline fragment capacity
F_BWD = 4_321_280       # backward padded capacity
F_BWD_TIGHT = 3_932_160  # tightened padded capacity candidate
N = 1_000_000
TILE_KEYS = 8161  # the tile keys' range: the bench's tiles and padding


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def draw(f_fwd: int = F_FWD, f_bwd: int = F_BWD,
         f_bwd_tight: int = F_BWD_TIGHT, n: int = N) -> dict:
    """The JAX tool's draws, in its order, as numpy arrays; each case's
    payloads stacked [m, F]."""
    rng = np.random.default_rng(0)

    def data(f, n_pay):
        tile = rng.integers(0, TILE_KEYS, f).astype(np.int32)
        depth = rng.random(f).astype(np.float32)
        pays = np.stack([rng.random(f).astype(np.float32)
                         for _ in range(n_pay)])
        return tile, depth, pays

    out = {}
    out["tile"], out["depth"], out["pays"] = data(f_fwd, 10)
    out["gid_b"], _, out["pays_b"] = data(f_bwd, 9)
    out["gid_t"], _, out["pays_t"] = data(f_bwd_tight, 9)
    out["flag"] = rng.integers(0, 2, n).astype(np.int32)
    out["depth_n"] = rng.random(n).astype(np.float32)
    out["pays_n"] = np.stack([rng.random(n).astype(np.float32)
                              for _ in range(24)])
    return out


def inputs(arrays: dict, device) -> dict:
    """The draws as tensors on ``device``."""
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


def sort_payloads(key, pays, second=None, stable: bool = True):
    """The port's sort with payloads: (sorted key, payload rows [m, F]
    gathered by its permutation). With a ``second`` key, two stable
    passes (by ``second``, then by ``key`` of that order): (sorted key,
    sorted second, payloads)."""
    if second is None:
        key_sorted, perm = torch.sort(key, stable=stable)
        return key_sorted, pays[:, perm]
    by_second = torch.sort(second, stable=True).indices
    key_sorted, order = torch.sort(key[by_second], stable=True)
    perm = by_second[order]
    return key_sorted, second[perm], pays[:, perm]


def stages(x: dict) -> dict:
    """Cases A-I on the tensors of :func:`inputs`, by the JAX tool's
    labels."""
    tile, depth, pays = x["tile"], x["depth"], x["pays"]
    tab_pays = torch.cat([x["depth_n"][None], x["pays_n"]])  # depth + 24
    return {
        "A fwd: stable 2key(i32,f32)+10pay @3.28M":
            lambda: sort_payloads(tile, pays, second=depth),
        "B fwd: stable 1key+10pay @3.28M":
            lambda: sort_payloads(tile, pays),
        "C fwd: unstable 1key+10pay @3.28M":
            lambda: sort_payloads(tile, pays, stable=False),
        "D fwd: stable 1key+4pay @3.28M":
            lambda: sort_payloads(tile, pays[:4]),
        "E fwd: stable 1key+1pay @3.28M":
            lambda: sort_payloads(tile, pays[:1]),
        "F bwd: unstable 1key+9pay @4.32M":
            lambda: sort_payloads(x["gid_b"], x["pays_b"], stable=False),
        "G bwd: unstable 1key+9pay @3.93M":
            lambda: sort_payloads(x["gid_t"], x["pays_t"], stable=False),
        "H tab: stable 1key+25pay @1M (current)":
            lambda: sort_payloads(x["flag"], tab_pays),
        "I tab: stable 2key(i32,f32)+24pay @1M":
            lambda: sort_payloads(x["flag"], x["pays_n"],
                                  second=x["depth_n"]),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
    dev = require_card(args.device, "bench_sort_shapes")
    todo = stages(inputs(draw(), dev))
    return report("bench_sort_shapes", dev, args,
                  read_stages(todo, args.iters))


if __name__ == "__main__":
    main()
