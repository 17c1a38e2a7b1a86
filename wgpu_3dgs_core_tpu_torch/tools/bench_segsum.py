"""K10: the segment sums (K5) stripped level by level.

The counterpart of ``tools/bench_segsum.py``, which attributes the TPU
``_segsum_kernel``'s cost by removing one ingredient at a time. The port
asks the same question of K5 (``csrc/segreduce.cu``: one warp per row of
the compacted gid column, two binary searches, a read through the sort's
permutation, a fixed-order warp reduction). Levels, cumulative, in
``csrc/variants.cu`` (wrapped by ``ops/variants.py``):

- ``s0_stream``: each warp sums a fixed run of ``f // rows`` slots of the
  gradients already in key order: no search, no permutation (the
  streaming floor);
- ``s1_search``: adds the two searches for the row's run, still over the
  key-ordered gradients: K5's summation order, so K5's output bit for bit;
- ``s2_gather``: adds the read through the permutation: K5 itself;
- ``prod_b128``, ``prod_b512``: K5 at 128 and 512 threads per block.

Levels 0-1 read ``grad[:, perm]``, made once outside the timed region
(``ops/variants.py::level_operand``). ``torch.segment_reduce`` over the
same data is timed beside them as the library's yardstick.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_segsum \\
        [--f-pad 3955712] [--gaussians 1000000] [--seed 0] [--device cuda]

The default stream is the TPU tool's synthetic one: ``f-pad`` keys drawn
uniformly over the gaussians, sorted (stably; the permutation is the
sort's), normal gradients in slot order.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.segreduce import GRAD_ROWS
from ..ops.variants import (
    SEGSUM_LEVELS,
    level_operand,
    segment_sums_level,
)
from ..utils.profiling import block_and_time, device_name


def synthetic_stream(f_pad: int, n: int, seed: int = 0, device="cuda"):
    """The TPU tool's stream in K5's form: (keys int32 [f_pad] sorted,
    perm int64 [f_pad], grad f32 [9, f_pad] in slot order, gid_col int32
    [n]: the distinct keys, then the sentinel n)."""
    rng = np.random.default_rng(seed)
    slot_keys = torch.from_numpy(rng.integers(0, n, f_pad).astype(np.int32))
    grad = torch.from_numpy(rng.normal(size=(GRAD_ROWS, f_pad))
                            .astype(np.float32))
    keys, perm = torch.sort(slot_keys, stable=True)
    live = torch.unique(keys)
    gid_col = torch.full((n,), n, dtype=torch.int32)
    gid_col[:live.shape[0]] = live
    return tuple(t.to(device) for t in (keys, perm, grad, gid_col)) + (n,)


def segment_reduce_call(keys, perm, grad, gid_col, n: int):
    """The one PyTorch call computing K5's function: ``segment_reduce``
    over the gradient rows of the live runs, gathered in key order once
    outside the call. Returns a callable giving [rows, 9]."""
    lo = torch.searchsorted(keys, gid_col)
    hi = torch.searchsorted(keys, gid_col, right=True)
    lengths = torch.where(gid_col < n, hi - lo, 0)
    drawn = int(lengths.sum())
    data = grad[:, perm[:drawn]].T.contiguous()

    def call():
        return torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                                    unsafe=True)

    return call


def run(keys, perm, grad, gid_col, n: int, iters: int = 10,
        warmup: int = 2) -> dict:
    """Time every level (and ``segment_reduce``) on one stream. Returns ms,
    us per row, and the step from the level before, per level."""
    rows = gid_col.shape[0]
    result: dict = {"device": device_name(grad.device), "f": keys.shape[0],
                    "rows": rows, "levels": {}}
    prev = None
    for name in SEGSUM_LEVELS:
        operand = level_operand(name, grad, perm)
        sec = block_and_time(name, segment_sums_level, name, keys, perm,
                             operand, gid_col, n, iters=iters, warmup=warmup)
        ms = sec * 1e3
        result["levels"][name] = {
            "ms": ms, "us_per_row": ms * 1e3 / rows,
            "step_us_per_row": None if prev is None
            else (ms - prev) * 1e3 / rows,
        }
        if name in ("s0_stream", "s1_search", "s2_gather"):
            prev = ms
    lib = segment_reduce_call(keys, perm, grad, gid_col, n)
    result["segment_reduce_ms"] = block_and_time(
        "segment_reduce", lib, iters=iters, warmup=warmup) * 1e3
    return result


def print_levels(result: dict) -> None:
    for name, r in result["levels"].items():
        step = ("" if r["step_us_per_row"] is None
                else f"  (step {r['step_us_per_row']:+.5f} us/row)")
        print(f"{name:>10s}: {r['ms']:8.4f} ms  {r['us_per_row']:.5f} us/row"
              f"{step}", flush=True)
    print(f"segment_reduce: {result['segment_reduce_ms']:.4f} ms", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f-pad", type=int, default=3_955_712)
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    stream = synthetic_stream(args.f_pad, args.gaussians, args.seed,
                              args.device)
    result = run(*stream, iters=args.iters)
    print_levels(result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
