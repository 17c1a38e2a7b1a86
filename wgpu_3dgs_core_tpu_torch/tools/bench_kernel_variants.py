"""K9: the forward rasterizer (K3) stripped level by level.

The counterpart of ``tools/bench_kernel_variants.py``, which attributes the
TPU forward blend's per-block cost by adding one ingredient per level over
the same inputs. The port asks it of K3 (``csrc/rasterize.cu``: one
256-thread block per 16x16 tile, fragments staged through shared memory
in batches). Levels, cumulative, in ``csrc/variants.cu`` (wrapped by
``ops/variants.py``):

- ``v0_stage``: the batch staging, plus one staged value (opacity) summed
  per pixel;
- ``v1_q``: the conic q of every (pixel, fragment) pair, summed;
- ``v2_alpha``: alpha (exp, clamp, cutoff and 1/255 tests), the kept
  alphas summed;
- ``v3_trans``: the T recurrence over the kept fragments (blending while
  T > 1e-4, never leaving the loop), no colour: K3's tile for black
  fragments;
- ``v4_color``: the colour accumulation, still with no early exit: K3's
  tile;
- ``v5_full``: K3's body with its per-pixel stop and block-wide exit: K3's
  tile bit for bit;
- ``v6_notrans``: ``v5_full`` with exp(-q/2) replaced by 1 - q/2: the
  step from ``v6`` to ``v5`` prices the transcendental.

Levels 0-2 give their per-pixel sum in channel 0 (channels 1-3 zero);
levels 3-6 a K3 tile [4, 256]. The TPU tool's MXU levels (``v3_alpha_mxu``,
``v4``/``v5_cumsum``, ``v6_full_mxuacc``) and ``v9_nosum`` price matmuls
and lane-tree sums K3 does not do, and have no level here.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_kernel_variants \\
        [--gaussians 1000000] [--width 1920] [--height 1080] [--device cuda]

The stream is the port bench's scene binned by the port's own render
path (capacities measured for it, ``pad_slack`` 0.65).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from ..bench import bench_camera, synthetic_scene
from ..ops.binning import (
    CHUNK,
    bin_splats_attrs,
    num_tiles,
    pad_schedule,
    padded_capacity,
)
from ..ops.rasterize import Q_CUTOFF
from ..ops.variants import RASTER_LEVELS, rasterize_level
from ..render.renderer import (
    measure_capacities,
    project_and_color,
    tile_local_stream,
)
from ..utils.profiling import block_and_time, device_name


def bench_stream(scene, camera, max_fragments: int, max_rows: int,
                 pad_slack: float = 0.65, sh_deg: int = 3,
                 background=(0.0, 0.0, 0.0)):
    """K3's arguments for ``scene`` (means, cov6, colour, opacity, sh) as
    ``render`` makes them at these capacities: (frags, tile_start,
    draw_len, background)."""
    means, cov6, color, opac, sh = scene
    tiles_x, tiles_y = num_tiles(camera.width, camera.height)
    f_cap = -(-max_fragments // CHUNK) * CHUNK
    with torch.no_grad():
        splats, rgb, op = project_and_color(means, cov6, color, opac, camera,
                                            sh=sh, sh_deg=sh_deg)
        attr_cols = torch.cat([splats.xy.T, splats.conic.T, rgb.T,
                               (op * splats.mask)[None, :]], dim=0)
        stream, attrs_sorted, _ = bin_splats_attrs(
            splats.xy, splats.extent, splats.depth, splats.mask, attr_cols,
            tiles_x, tiles_y, f_cap, max_rows=max_rows)
        sched = pad_schedule(stream, padded_capacity(
            f_cap, tiles_x * tiles_y, pad_slack))
        frags = tile_local_stream(attrs_sorted, stream.tile_id, tiles_x)
    return frags, stream.tile_start, sched.draw_len, tuple(background)


def run(frags, tile_start, tile_len, bg, cutoff_sq: float = Q_CUTOFF,
        mode: int = 0, iters: int = 10, warmup: int = 2) -> dict:
    """Time every level on one stream. Returns ms, us per tile, and the
    step from the level before, per level."""
    n_t = tile_start.shape[0]
    result: dict = {"device": device_name(frags.device), "tiles": n_t,
                    "fragments": int(tile_len.sum()), "levels": {}}
    prev = None
    for name in RASTER_LEVELS:
        sec = block_and_time(name, rasterize_level, name, frags, tile_start,
                             tile_len, bg, cutoff_sq, mode, iters=iters,
                             warmup=warmup)
        ms = sec * 1e3
        result["levels"][name] = {
            "ms": ms, "us_per_tile": ms * 1e3 / n_t,
            "step_us_per_tile": None if prev is None
            else (ms - prev) * 1e3 / n_t,
        }
        prev = ms
    return result


def print_levels(result: dict) -> None:
    for name, r in result["levels"].items():
        step = ("" if r["step_us_per_tile"] is None
                else f"  (step {r['step_us_per_tile']:+.4f} us/tile)")
        print(f"{name:>10s}: {r['ms']:8.4f} ms  {r['us_per_tile']:.4f} "
              f"us/tile{step}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scene = synthetic_scene(args.gaussians, device=args.device)
    cam = bench_camera(args.width, args.height)
    caps = measure_capacities(scene[0], scene[1], scene[3], cam)
    stream = bench_stream(scene, cam, *caps)
    result = run(*stream, iters=args.iters)
    print_levels(result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
