"""K10: the segment sums (K5) stripped level by level.

The counterpart of ``tools/bench_segsum.py``, which attributes the TPU
``_segsum_kernel``'s cost by removing one ingredient at a time. The port
asks it of K5 as it runs (``csrc/segreduce.cu``: a staging kernel, then a
segmented scan with its lanes over the sorted slots). The levels are
instantiations of K5's own source (``csrc/segsum.cuh``, wrapped by
``ops/variants.py``), cumulative:

- ``s0_prep``: K5's first kernel alone: the slot-major staging copy
  [9, F] -> [F, 9], the row map, the zeroed output;
- ``s1_scan``: adds the segmented scan over a slot-major copy already in
  key order: no gather (the operand is ``grad[:, perm]``, made once outside
  the timed region by ``ops/variants.py::level_operand``);
- ``s2_gather``: adds the read through the sort's permutation: K5 itself,
  bit for bit;
- ``s2_nostage``: ``s2_gather`` reading [9, F] through the permutation,
  with no staging copy: its step from ``s2_gather`` prices the copy.

``torch.segment_reduce`` over the same data, the library's yardstick, is
timed beside them. On a card every time is device time (torch.profiler,
``utils/profiling.py::kernel_ms``).

:func:`hard_streams` gives the streams K5's design finds hard.

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

from ..ops.segreduce import GRAD_ROWS, SEGSUM_CHUNK
from ..ops.variants import (
    SEGSUM_LEVELS,
    level_operand,
    segment_sums_level,
)
from ..utils.profiling import device_name, kernel_ms


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


HARD_STREAMS = ("long_run", "straddling", "empty", "all_drawn",
                "one_gaussian", "live_no_slot", "missing_key")


def _runs_cut_at(rng, total: int, cut: int, straddle: bool):
    """Run lengths of 1-9 slots summing to ``total``: with ``straddle`` no
    run starts at a multiple of ``cut`` (every boundary lies inside a
    run), else a run starts at each (every boundary ends one)."""
    lengths, pos = [], 0
    while pos < total:
        length = min(int(rng.integers(1, 10)), total - pos)
        end = pos + length
        if straddle and end % cut == 0 and end < total:
            length += 1
        elif not straddle and pos // cut != (end - 1) // cut:
            length = (pos // cut + 1) * cut - pos
        lengths.append(length)
        pos += length
    return np.array(lengths)


def hard_streams(device="cpu"):
    """Streams in K5's form that its design finds hard, each of 6 chunks of
    slots (``SEGSUM_CHUNK``, walked in tiles of half a chunk) over 3,000
    gaussians, one shape for all: a run longer than three chunks, every
    tile end inside a run, no drawn slot, every slot drawn (a run ending
    at each tile end), one gaussian owning every slot, live rows with no
    drawn slot, drawn keys missing from the gid column. Each is made as
    render's backward makes it: gaussian ids dealt to random slots, the
    rest keyed ``n + slot``, stably sorted. Returns {name: (keys, perm,
    grad, gid_col, n)}."""
    chunk = SEGSUM_CHUNK
    n, f, tile = 3000, 6 * chunk, chunk // 2
    out = {}
    for i, name in enumerate(HARD_STREAMS):
        rng = np.random.default_rng(i)
        counts = np.zeros(n, np.int64)
        if name == "long_run":
            counts[:] = rng.integers(0, 3, n)
            counts[1000] = 3 * chunk + chunk // 2
        elif name in ("straddling", "all_drawn"):
            straddle = name == "straddling"
            lengths = _runs_cut_at(rng, f - chunk if straddle else f, tile,
                                   straddle)
            gids = np.sort(rng.choice(n, lengths.shape[0], replace=False))
            counts[gids] = lengths
        elif name == "one_gaussian":
            counts[1234] = f
        elif name != "empty":
            counts[:] = rng.integers(0, 5, n)
        live = counts > 0
        if name in ("empty", "one_gaussian", "live_no_slot"):
            live |= rng.random(n) < 0.2  # live rows with no drawn slot
        if name == "missing_key":
            live &= rng.random(n) >= 0.1
        drawn = np.repeat(np.arange(n), counts)
        slot_keys = n + np.arange(f)
        slot_keys[np.sort(rng.choice(f, drawn.shape[0], replace=False))] = (
            rng.permutation(drawn))
        keys, perm = torch.sort(torch.from_numpy(slot_keys.astype(np.int32)),
                                stable=True)
        gid_col = np.full(n, n, np.int32)
        gid_col[:int(live.sum())] = np.nonzero(live)[0]
        grad = rng.normal(size=(GRAD_ROWS, f)).astype(np.float32)
        out[name] = tuple(
            t.to(device) for t in (keys, perm, torch.from_numpy(grad),
                                   torch.from_numpy(gid_col))) + (n,)
    return out


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
    """Time every level and ``segment_reduce`` on one stream. Returns,
    per level, ms, us per row and the step from the level before (ms)."""
    rows = gid_col.shape[0]
    result: dict = {"device": device_name(grad.device), "f": keys.shape[0],
                    "rows": rows, "levels": {}}
    prev = None
    for name in SEGSUM_LEVELS:
        operand = level_operand(name, grad, perm)
        ms = kernel_ms(name, segment_sums_level, name, keys, perm, operand,
                       gid_col, n, iters=iters, warmup=warmup)
        result["levels"][name] = {
            "ms": ms, "us_per_row": ms * 1e3 / rows,
            "step_ms": None if prev is None else ms - prev,
        }
        prev = ms
    lib = segment_reduce_call(keys, perm, grad, gid_col, n)
    result["segment_reduce_ms"] = kernel_ms("segment_reduce", lib,
                                            iters=iters, warmup=warmup)
    return result


def print_levels(result: dict) -> None:
    for name, r in result["levels"].items():
        step = "" if r["step_ms"] is None else f"  (step {r['step_ms']:+.4f})"
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
