"""The port bench: forward + backward render throughput on the card.

    python -m wgpu_3dgs_core_tpu_torch.bench [--small] [--full] [--device cuda]

The counterpart of the repository's ``bench.py`` (the JAX package's TPU
bench, which stays as it is): the same scenes, drawn with numpy in the
same order (``synthetic_scene``, ``heavy_scene``), the same camera,
capacities, ``pad_slack`` and iterations, and the same one JSON line:

  {"metric", "value" (Mpix/s), "unit", "vs_baseline", "msplats_s",
   "step_ms", "loss", "overflow"}

plus, with ``--full``, ``fwd_ms``, ``bwd_ms``, ``heavy_mpix_s``,
``heavy_step_ms`` and ``heavy_overflow``. The step is forward + backward
of mean((image - 0)^2) with respect to (means, cov6, colour, opacity, sh)
through the port's ``render``; its time is the wall time per step over
back-to-back steps, the card synchronised before and after. The metric
names the device it ran on. ``vs_baseline`` keeps bench.py's 250 Mpix/s
for the line's contract: it is no target for the card.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from .ops.transforms import cov3d_from_rot_scale
from .render.camera import Camera
from .render.renderer import render
from .utils.profiling import device_name, timed

BASELINE_MPIX_S = 250.0
# bench.py's capacities at 1M gaussians (the headline and heavy scenes'
# measured streams with ~1.12x / 1.22x headroom) and its --small ones.
CAPACITIES = dict(max_fragments=2_957_312, heavy_max_fragments=7_311_360,
                  max_rows=1_887_232, heavy_max_rows=2_894_848)
SMALL = dict(gaussians=10_000, width=512, height=512,
             max_fragments=262_144, heavy_max_fragments=1_048_576,
             max_rows=131_072, heavy_max_rows=262_144, iters=3, warmup=1)


def synthetic_scene(n: int, seed: int = 0, spread: float = 3.0,
                    scale_lo: float = 0.004, scale_hi: float = 0.012,
                    device="cuda"):
    """bench.py's cloud of few-pixel splats over the frustum, drawn in the
    same order with the same generator: (means [n, 3], cov6 [n, 6] by the
    port's cov3d_from_rot_scale, colour [n, 3], opacity [n], sh [n, 15,
    3]) on ``device``."""
    rng = np.random.default_rng(seed)
    means = np.empty((n, 3), np.float32)
    means[:, 0] = rng.uniform(-spread, spread, n)
    means[:, 1] = rng.uniform(-spread * 0.6, spread * 0.6, n)
    means[:, 2] = rng.uniform(-2.0, 2.0, n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = rng.uniform(scale_lo, scale_hi, (n, 3)).astype(np.float32)
    color = rng.random((n, 3)).astype(np.float32)
    opac = (0.2 + 0.7 * rng.random(n)).astype(np.float32)
    sh = (0.1 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    dev = torch.device(device)
    means, q, scales, color, opac, sh = (
        torch.from_numpy(a).to(dev)
        for a in (means, q, scales, color, opac, sh))
    return means, cov3d_from_rot_scale(q, scales), color, opac, sh


def heavy_scene(n: int, seed: int = 1, device="cuda"):
    """Capture-like overlap: larger splats, >= 8 fragments a gaussian."""
    return synthetic_scene(n, seed=seed, scale_lo=0.010, scale_hi=0.030,
                           device=device)


def bench_camera(width: int, height: int) -> Camera:
    return Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                          width=width, height=height, fov_y=0.9)


def make_step(camera: Camera, max_fragments: int, max_rows: int,
              pad_slack: float, sh_deg: int):
    """The bench step: ``step(params) -> (loss, overflow, grads)``, the
    forward + backward of mean(image^2) w.r.t. the five ``params`` (leaf
    tensors requiring grad)."""
    kw = dict(sh_deg=sh_deg, background=(0.0, 0.0, 0.0),
              max_fragments=max_fragments, pad_slack=pad_slack,
              max_rows=max_rows)

    def step(params):
        means, cov6, color, opac, sh = params
        res = render(means, cov6, color, opac, camera, sh=sh, **kw)
        loss = torch.mean(res.image ** 2)
        return loss.detach(), res.overflow, torch.autograd.grad(loss, params)

    def forward(params):
        with torch.no_grad():
            means, cov6, color, opac, sh = params
            res = render(means, cov6, color, opac, camera, sh=sh, **kw)
            return torch.mean(res.image ** 2), res.overflow

    return step, forward


def time_steps(fn, params, warmup: int, iters: int):
    """Seconds per call of ``fn(params)`` over ``iters`` back-to-back calls
    after ``warmup``, the card synchronised before and after; and the last
    call's output."""
    dev = params[0].device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = None
    for _ in range(max(warmup, 1)):
        out = fn(params)
    sync()
    times: dict = {}
    with timed("step", times):
        for _ in range(iters):
            out = fn(params)
        sync()
    return times["step"] / iters, out


def leaves(scene):
    return [t.detach().clone().requires_grad_(True) for t in scene]


def run(args) -> dict:
    """The bench at ``args`` (parsed by :func:`parse`). Returns its JSON
    line as a dict."""
    dev = torch.device(args.device)
    cam = bench_camera(args.width, args.height)
    npix = args.width * args.height
    params = leaves(synthetic_scene(args.gaussians, device=dev))
    step, forward = make_step(cam, args.max_fragments, args.max_rows,
                              args.pad_slack, args.sh_deg)
    dt, (loss, overflow, _) = time_steps(step, params, args.warmup,
                                         args.iters)
    extras = {}
    if args.full:
        dt_f, _ = time_steps(forward, params, args.warmup, args.iters)
        extras["fwd_ms"] = round(dt_f * 1e3, 2)
        extras["bwd_ms"] = round((dt - dt_f) * 1e3, 2)
        del params  # the heavy scene's step needs the room
        hparams = leaves(heavy_scene(args.gaussians, device=dev))
        hstep, _ = make_step(cam, args.heavy_max_fragments,
                             args.heavy_max_rows, args.pad_slack,
                             args.sh_deg)
        dt_h, (_, h_overflow, _) = time_steps(hstep, hparams, args.warmup,
                                              args.iters)
        extras["heavy_mpix_s"] = round(npix / dt_h / 1e6, 2)
        extras["heavy_step_ms"] = round(dt_h * 1e3, 2)
        extras["heavy_overflow"] = bool(h_overflow)
    mpix_s = npix / dt / 1e6
    return {
        "metric": "fwd+bwd render throughput "
                  f"({args.height}p, {args.gaussians} gaussians, "
                  f"sh_deg={args.sh_deg}, {device_name(dev)})",
        "value": round(mpix_s, 2),
        "unit": "Mpix/s",
        "vs_baseline": round(mpix_s / BASELINE_MPIX_S, 4),
        "msplats_s": round(args.gaussians / dt / 1e6, 2),
        "step_ms": round(dt * 1e3, 2),
        "loss": float(loss),
        "overflow": bool(overflow),
        **extras,
    }


def parse(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--max-fragments", type=int,
                    default=CAPACITIES["max_fragments"])
    ap.add_argument("--heavy-max-fragments", type=int,
                    default=CAPACITIES["heavy_max_fragments"])
    ap.add_argument("--max-rows", type=int, default=CAPACITIES["max_rows"])
    ap.add_argument("--heavy-max-rows", type=int,
                    default=CAPACITIES["heavy_max_rows"])
    ap.add_argument("--pad-slack", type=float, default=0.65)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--sh-deg", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="tiny config for smoke testing (bench.py's)")
    ap.add_argument("--full", action="store_true",
                    help="also the forward-only split and the heavy scene")
    args = ap.parse_args(argv)
    if args.small:
        for k, v in SMALL.items():
            setattr(args, k, v)
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    result = run(parse(argv))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
