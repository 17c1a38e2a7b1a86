"""K11: how a grid is bounded by a count that lives on the device.

The counterpart of ``tools/probe_dyngrid.py``, which asks whether a Pallas
TPU grid may be sized by a traced count. This tool checks the three launch
forms of ``ops/probe.py`` (a capacity grid whose dead blocks return at
once, a host readback of the count, a launch from the device) at the TPU
probe's shape (8 blocks of [8, 128] f32, 3 and 8 live) and at the
rasterizer's (8,160 blocks of 256 f32, 1,000 and 8,160 live), and times
each form at the latter: per call over back-to-back calls by CUDA events
(what a caller pays, the host's pace included) and the kernels' own time
by torch.profiler.

    python -m wgpu_3dgs_core_tpu_torch.tools.probe_dyngrid [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from ..ops.probe import FORMS, probe, probe_plain
from ..utils.profiling import block_and_time, device_kernel_ms, device_name

# (capacity blocks, f32 per block, live counts checked): the TPU probe's
# [64, 128] array in [8, 128] blocks, and the rasterizer's 8,160 tiles.
TPU_CASE = (8, 1024, (3, 8))
RASTER_CASE = (8160, 256, (1000, 8160))
SENTINEL = -7.0  # what `out` holds before a probe: kept past the prefix


def _case(device, cap: int, block_elems: int, live: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(cap * block_elems, generator=gen).to(device)
    count = torch.tensor([live], dtype=torch.int32, device=device)
    return x, count


def run(device, cases=(TPU_CASE, RASTER_CASE), iters: int = 10,
        warmup: int = 2) -> dict:
    """Check every form against its plain version in every case (the live
    prefix x + 1, the rest the sentinel, bit for bit) and time each form
    at the last case's shape: ``ms`` per call over back-to-back calls and
    ``device_ms``, the kernels' own time per call (None off the card)."""
    device = torch.device(device)
    result: dict = {"device": device_name(device), "checked": [],
                    "max_abs_err": 0.0, "ms": {}, "device_ms": {}}
    for k, (cap, block_elems, lives) in enumerate(cases):
        for live in lives:
            x, count = _case(device, cap, block_elems, live, seed=k)
            want = probe_plain(x, torch.full_like(x, SENTINEL), count,
                               block_elems)
            for form in FORMS:
                got = probe(form, x, torch.full_like(x, SENTINEL), count,
                            block_elems)
                err = float((got - want).abs().max())
                result["max_abs_err"] = max(result["max_abs_err"], err)
                if not torch.equal(got, want):
                    raise RuntimeError(
                        f"K11 {form}: {live} of {cap} blocks of "
                        f"{block_elems} differ from x + 1 / the sentinel")
            result["checked"].append(f"{live}/{cap}x{block_elems}")
    cap, block_elems, lives = cases[-1]
    for live in lives:
        x, count = _case(device, cap, block_elems, live, seed=len(cases))
        out = torch.full_like(x, SENTINEL)
        for form in FORMS:
            key = f"{form}_{live}"
            args = (form, x, out, count, block_elems)
            result["ms"][key] = 1e3 * block_and_time(
                key, probe, *args, iters=iters, warmup=warmup)
            result["device_ms"][key] = (
                device_kernel_ms(probe, *args, iters=iters)
                if device.type == "cuda" else None)
    return result


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    result = run(args.device, iters=args.iters)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
