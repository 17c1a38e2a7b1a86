"""Bench-shape gradient parity: the render path against the brute-force
reference renderer's autograd.

The counterpart of ``tools/grad_parity_tpu.py``. The CPU parity tests hold
the gradients to 1e-4 (normalized) at a few hundred gaussians; this tool
makes the same comparison at bench scale: 100,000 gaussians of the bench
scene under a full 1080p camera. The loss is an MSE over a 256x256 crop:
``render`` draws the full image (the real binning, sorts and kernels at
scale) and takes the crop; ``render_reference`` evaluates only the crop's
pixels (``pixel_window``), in chunks of rows, since the dense
O(N * pixels) evaluation of the whole image does not fit. Cropping the
loss only restricts which pixels send cotangents: both paths see the same
gradient math for every parameter.

    python -m wgpu_3dgs_core_tpu_torch.tools.grad_parity \\
        [--gaussians 100000] [--crop 256] [--device cuda]

Prints one JSON line with each parameter's normalized max error,
max |g_render - g_ref| / max |g_ref|; the bar is 1e-4.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from ..bench import bench_camera, leaves, synthetic_scene
from ..render.reference import render_reference
from ..render.renderer import render
from ..utils.profiling import device_name

BAR = 1e-4
NAMES = ("means", "cov3d", "color", "opacity", "sh")
TARGET = 0.35


def run(gaussians: int = 100_000, width: int = 1920, height: int = 1080,
        crop: int = 256, chunk_rows: int = 8, sh_deg: int = 3,
        device="cuda") -> dict:
    """Both gradients of the crop loss and their normalized errors."""
    dev = torch.device(device)
    scene = synthetic_scene(gaussians, device=dev)
    cam = bench_camera(width, height)
    x0, y0 = (width - crop) // 2, (height - crop) // 2
    norm = 3.0 * crop * crop
    bg = (0.0, 0.0, 0.0)

    t0 = time.perf_counter()
    params = leaves(scene)
    res = render(*params[:4], cam, sh=params[4], sh_deg=sh_deg,
                 background=bg)
    img = res.image[y0:y0 + crop, x0:x0 + crop]
    loss = torch.sum((img - TARGET) ** 2) / norm
    g_mine = torch.autograd.grad(loss, params)
    loss_mine, overflow = float(loss.detach()), bool(res.overflow)
    t_mine = time.perf_counter() - t0

    t0 = time.perf_counter()
    params = leaves(scene)
    g_ref = [torch.zeros_like(p) for p in params]
    loss_ref = 0.0
    for row0 in range(y0, y0 + crop, chunk_rows):
        rows = min(chunk_rows, y0 + crop - row0)
        img = render_reference(*params[:4], cam, sh=params[4], sh_deg=sh_deg,
                               background=bg,
                               pixel_window=(x0, row0, crop, rows))
        chunk = torch.sum((img - TARGET) ** 2) / norm
        for acc, g in zip(g_ref, torch.autograd.grad(chunk, params)):
            acc += g
        loss_ref += float(chunk.detach())
    t_ref = time.perf_counter() - t0

    out = {
        "device": device_name(dev),
        "n": gaussians,
        "resolution": f"{width}x{height}",
        "crop": crop,
        "overflow": overflow,
        "loss_render": loss_mine,
        "loss_ref": loss_ref,
        "loss_rel_err": abs(loss_mine - loss_ref) / max(abs(loss_ref),
                                                        1e-12),
        "seconds_render": t_mine,
        "seconds_ref": t_ref,
    }
    worst = 0.0
    for name, a, b in zip(NAMES, g_mine, g_ref):
        scale = max(float(b.abs().max()), 1e-12)
        err = float((a - b).abs().max()) / scale
        out[f"err_{name}"] = err
        worst = max(worst, err)
    out["worst_normalized_err"] = worst
    out["pass_1e-4"] = worst <= BAR and not overflow
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--chunk-rows", type=int, default=8,
                    help="crop rows per reference chunk (memory bound)")
    ap.add_argument("--sh-deg", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # full f32 reference
    out = run(args.gaussians, args.width, args.height, args.crop,
              args.chunk_rows, args.sh_deg, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
