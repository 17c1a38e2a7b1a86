"""K9: the forward rasterizer (K3) stripped level by level.

The counterpart of ``tools/bench_kernel_variants.py``, which attributes the
TPU forward blend's per-block cost by adding one ingredient per level over
the same inputs. The port asks it of K3 as it runs (``csrc/rasterize.cu``:
one 256-thread block per 16x16 tile, each warp on an 8x4 pixel block,
fragments staged through shared memory in batches with their pixel boxes,
each warp walking only the fragments whose box meets its block). The
levels are instantiations of K3's own source (``csrc/rasterize_fwd.cuh``,
wrapped by ``ops/variants.py``), cumulative:

- ``v0_stage``: the batch staging and each fragment's pixel box; every
  pixel sums the staged opacities;
- ``v1_cull``: the warp's ballot walk over the fragments whose box meets
  its block, summing their opacities;
- ``v2_q``: q of each walked (pixel, fragment) pair, summed;
- ``v3_alpha``: alpha (exp, clamp, cutoff and 1/255 tests), the kept
  alphas summed;
- ``v4_trans``: the T recurrence while T > 1e-4, no stop, no colour: K3's
  tile for black fragments;
- ``v5_color``: the colour, still no stop: K3's tile;
- ``v6_full``: the per-pixel stop and the block's exit: K3 itself, bit for
  bit;
- ``v7_notrans``: ``v6_full`` with exp(-q/2) replaced by 1 - q/2: its step
  from ``v6_full`` prices the transcendental.

Levels 0-3 give their per-pixel sum in channel 0 (channels 1-3 zero);
levels 4-7 a K3 tile [4, 256]. On a card every time is device time
(torch.profiler, ``utils/profiling.py::kernel_ms``). The TPU tool's MXU
levels (``v3_alpha_mxu``, ``v4``/``v5_cumsum``, ``v6_full_mxuacc``) and
``v9_nosum`` price matmuls and lane-tree sums K3 does not do, and have no
level here.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_kernel_variants \\
        [--gaussians 1000000] [--width 1920] [--height 1080] [--device cuda]

The stream is the port bench's scene binned by the port's own render
path (capacities measured for it, ``pad_slack`` 0.65).

:func:`hard_tiles` gives the tiles the pixel-box cull finds hard.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..bench import bench_camera, synthetic_scene
from ..ops.binning import (
    CHUNK,
    bin_splats_attrs,
    num_tiles,
    pad_schedule,
    padded_capacity,
)
from ..ops.rasterize import (
    ALPHA_MIN,
    FRAG_ROWS,
    Q_CUTOFF,
    frag_pixel_box_plain,
)
from ..ops.variants import (
    RASTER_LEVELS,
    rasterize_level,
    staged_slots,
    warp_pixels,
)
from ..render.renderer import measure_capacities, project_and_color
from ..utils.profiling import device_name, kernel_ms


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
        stream, frags, _ = bin_splats_attrs(
            splats.xy, splats.extent, splats.depth, splats.mask, attr_cols,
            tiles_x, tiles_y, f_cap, max_rows=max_rows)
        sched = pad_schedule(stream, padded_capacity(
            f_cap, tiles_x * tiles_y, pad_slack))
    return frags, stream.tile_start, sched.draw_len, tuple(background)


HARD_TILES = ("box_edge", "thin_45", "opacity", "cover", "saturate",
              "ring", "tie")


def _conic(sx, sy, angle):
    """The conic (a, b, c) of a 2D gaussian with standard deviations sx, sy
    along axes turned by ``angle``, in f64."""
    cs, sn = np.cos(angle), np.sin(angle)
    ia, ib = 1.0 / sx ** 2, 1.0 / sy ** 2
    return (ia * cs * cs + ib * sn * sn, (ia - ib) * cs * sn,
            ia * sn * sn + ib * cs * cs)


def _edge_opacity(q):
    """The opacities at which 2 ln(255 op) = q, and the f32 values one
    step below and above each."""
    op = (np.exp(np.asarray(q, np.float64) / 2.0) / 255.0).astype(np.float32)
    return np.concatenate([op, np.nextafter(op, np.float32(0.0)),
                           np.nextafter(op, np.float32(1.0))])


def hard_tiles(device="cpu", seed: int = 0):
    """Tiles the pixel-box cull of K3 and K4 finds hard, in K3's stream
    form, each set a few tiles of a few hundred fragments: pixel centres
    exactly on a box edge (q at a pixel exactly cutoff^2 or 2 ln(255 op));
    thin ellipses at 45 degrees with (ac + b^2) / det from 10 to 2e6;
    opacities one f32 step either side of 1/255 and of the ones where
    2 ln(255 op) passes a pixel centre; splats covering the whole tile;
    saturation inside a batch and exactly at K4's and K3's batch ends
    (fragments 127, 128, 255, 256); ELLIPSE rings whose edges pass through
    pixel centres; alphas exactly on the 0.99 clamp (op 0.99 centred on a
    pixel centre, and every ELLIPSE ring pixel of such a fragment), where
    the kernels give alpha no gradient. Returns {name: (frags [9, F] f32,
    tile_start, tile_len int32 [T])}; every fragment is drawn."""
    out = {}
    for k, name in enumerate(HARD_TILES):
        rng = np.random.default_rng(seed + k)
        tiles = []
        if name in ("box_edge", "opacity", "ring"):
            for _ in range(6):
                n = 200
                # Centres on pixel centres and edges; pixel deltas then
                # fall on multiples of 0.5.
                x = rng.integers(-8, 48, n) / 2.0
                y = rng.integers(-8, 48, n) / 2.0
                if name == "box_edge":
                    s = rng.choice([1.0 / 3.0, 0.5, 1.0, 1.5, 2.0], (2, n))
                    a, b, c = _conic(s[0], s[1], 0.0)
                    op = rng.choice(np.concatenate(
                        [_edge_opacity([1.0, 2.0, 4.0, 5.0, 8.0, 9.0]),
                         [0.5, 0.9, 0.98]]), n)
                elif name == "opacity":
                    a, b, c = _conic(np.ones(n), np.ones(n), 0.0)
                    lo = np.float32(ALPHA_MIN)
                    op = rng.choice(np.concatenate(
                        [_edge_opacity([0.25, 0.5, 1.0, 1.25, 2.0, 4.25]),
                         [np.nextafter(lo, np.float32(0.0)), lo,
                          np.nextafter(lo, np.float32(1.0))]]), n)
                else:  # rings: q = 0.64 * 9 or 9 at pixel deltas
                    d = rng.choice([1.0, 1.5, 2.0, 2.5, 3.0, 4.0], (2, n))
                    q = rng.choice([0.64 * Q_CUTOFF, Q_CUTOFF], (2, n))
                    a, b, c = _conic(d[0] / np.sqrt(q[0]),
                                     d[1] / np.sqrt(q[1]), 0.0)
                    op = rng.uniform(0.05, 0.6, n)
                tiles.append((x, y, a, b, c, op))
        elif name == "thin_45":
            for ratio in (1e1, 1e3, 1e5, 5e5, 1e6, 2e6):
                n = 120
                lam = rng.uniform(0.5, 4.0, n)
                angle = np.pi / 4 + rng.choice([0.0, 1e-4, -1e-3], n)
                a, b, c = _conic(1.0 / np.sqrt(lam),
                                 1.0 / np.sqrt(lam / (2.0 * ratio)), angle)
                x = rng.uniform(-4.0, 20.0, n)
                y = rng.uniform(-4.0, 20.0, n)
                tiles.append((x, y, a, b, c, rng.uniform(0.02, 0.99, n)))
        elif name == "cover":
            for _ in range(4):
                n = 150
                s = rng.choice([8.0, 20.0, 50.0], n)
                a, b, c = _conic(s, s * rng.uniform(0.5, 1.0, n),
                                 rng.uniform(0, np.pi, n))
                x = rng.choice([8.0, -10.0, 30.0], n) + rng.normal(0, 2, n)
                y = rng.choice([8.0, -10.0, 30.0], n) + rng.normal(0, 2, n)
                tiles.append((x, y, a, b, c, rng.uniform(0.01, 0.3, n)))
        elif name == "tie":
            for _ in range(4):
                # One fragment in four at op 0.99 on a pixel centre, so
                # alpha_raw = 0.99 exp(0) ties the clamp there; the rest
                # light enough that the ties are not all occluded.
                n = 60
                x = rng.integers(0, 16, n) + 0.5
                y = rng.integers(0, 16, n) + 0.5
                s = rng.choice([0.75, 1.0, 2.0], (2, n))
                a, b, c = _conic(s[0], s[1], rng.uniform(0, np.pi, n))
                op = np.where(rng.random(n) < 0.25, np.float32(0.99),
                              rng.uniform(0.05, 0.4, n))
                tiles.append((x, y, a, b, c, op))
        else:  # saturate: T crosses 1e-4 at fragment 100, 127, 128, 255, 256
            for at in (100, 127, 128, 256, 257):
                # Near-flat splats: alpha 0.02 (T 0.98^k), then two at the
                # 0.99 clamp; the second, or the first once T < 0.01, ends
                # the blend at every pixel.
                n = at + 40
                op = np.full(n, 0.02)
                op[at - 1:at + 1] = 1.0
                a, b, c = _conic(np.full(n, 200.0), np.full(n, 160.0), 0.3)
                x = 8.0 + rng.normal(0, 0.5, n)
                y = 8.0 + rng.normal(0, 0.5, n)
                tiles.append((x, y, a, b, c, op))
        cols = []
        for x, y, a, b, c, op in tiles:
            rgb = rng.random((3, len(x)))
            cols.append(np.stack([x, y, a, b, c, *rgb, op]).astype(np.float32))
        lens = np.array([col.shape[1] for col in cols], np.int32)
        start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
        frags = np.concatenate(cols, axis=1)
        assert frags.shape[0] == FRAG_ROWS
        out[name] = tuple(torch.from_numpy(t).to(device)
                          for t in (frags, start, lens))
    return out


def cull_counts(frags, tile_start, draw_len, cutoff_sq: float = Q_CUTOFF,
                mode: int = 0) -> tuple[int, int]:
    """The (warp, fragment) pairs of the drawn fragments that the pixel-box
    cull of K3 and K4 keeps and skips: a warp keeps a fragment when the
    fragment's box (``frag_pixel_box_plain``) meets its pixels. Returns
    (kept, skipped)."""
    slots = staged_slots(tile_start, draw_len)
    drawn = slots.shape[0]
    box = frag_pixel_box_plain(frags[:, slots], cutoff_sq, mode)  # [4, D]
    pix = warp_pixels().to(frags.device)
    cols, rows = pix % 16, pix // 16
    x0, x1 = cols.amin(dim=1), cols.amax(dim=1)
    y0, y1 = rows.amin(dim=1), rows.amax(dim=1)
    hits = ((box[0, :, None] <= x1) & (box[1, :, None] >= x0)
            & (box[2, :, None] <= y1) & (box[3, :, None] >= y0))
    kept = int(hits.sum())
    return kept, 8 * drawn - kept


def run(frags, tile_start, tile_len, bg, cutoff_sq: float = Q_CUTOFF,
        mode: int = 0, iters: int = 10, warmup: int = 2) -> dict:
    """Time every level on one stream. Returns, per level, ms, us per
    tile and the step from the level before (ms)."""
    n_t = tile_start.shape[0]
    result: dict = {"device": device_name(frags.device), "tiles": n_t,
                    "fragments": int(tile_len.sum()), "levels": {}}
    args = (frags, tile_start, tile_len, bg, cutoff_sq, mode)
    prev = None
    for name in RASTER_LEVELS:
        ms = kernel_ms(name, rasterize_level, name, *args, iters=iters,
                       warmup=warmup)
        result["levels"][name] = {
            "ms": ms, "us_per_tile": ms * 1e3 / n_t,
            "step_ms": None if prev is None else ms - prev,
        }
        prev = ms
    return result


def print_levels(result: dict) -> None:
    for name, r in result["levels"].items():
        step = "" if r["step_ms"] is None else f"  (step {r['step_ms']:+.4f})"
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
