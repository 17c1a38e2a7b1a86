"""Render a gaussian scene (PLY or SPZ, by its suffix) to an image
(the repo's examples/render_scene.py).

Writes the image as a float32 [H, W, 3] array in .npy form to OUT
(default: a temporary directory).

Usage: python -m wgpu_3dgs_core_tpu_torch.examples.render_scene
           [scene.ply|scene.spz] [out.npy] [--width W] [--height H]
           [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from wgpu_3dgs_core_tpu_torch import (
    Camera,
    Gaussians,
    GaussiansBuffer,
    GaussiansSource,
    render_gaussians,
)

from ._cli import MODEL_PLY, output_path, parser


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("scene", nargs="?", default=str(MODEL_PLY))
    p.add_argument("out", nargs="?")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    args = p.parse_args(argv)
    source = (GaussiansSource.SPZ if args.scene.endswith(".spz")
              else GaussiansSource.PLY)
    soa = Gaussians.read_from_file(args.scene, source).to_soa()
    buf = GaussiansBuffer.new(soa, device=args.device)
    center = soa.pos.mean(axis=0)
    extent = float(np.abs(soa.pos - center).max()) + 1.0
    cam = Camera.look_at(
        eye=center + np.array([0.0, -0.5 * extent, -2.5 * extent]),
        target=center, width=args.width, height=args.height, fov_y=0.9,
    )
    res = render_gaussians(buf, cam, background=(1.0, 1.0, 1.0))
    if bool(res.overflow):
        raise RuntimeError("the render overflowed its fragment capacity")
    img = np.clip(res.image.cpu().numpy(), 0.0, 1.0)
    with output_path(args.out, "render.npy") as path:
        np.save(path, img)
        print(f"rendered {len(buf)} gaussians at {args.width}x{args.height} "
              f"on {buf.device} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
