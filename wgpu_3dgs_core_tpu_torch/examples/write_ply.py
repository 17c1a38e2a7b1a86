"""Write a small gaussian scene to PLY (the repo's examples/write_ply.py).

Builds three axis-coloured gaussians, sends them through a device buffer
and back (the lossless default layout), writes them to OUT (default: a
temporary directory) and reads the file back.

Usage: python -m wgpu_3dgs_core_tpu_torch.examples.write_ply [out.ply]
           [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from wgpu_3dgs_core_tpu_torch import GaussiansBuffer, GaussianSoA, read_ply

from ._cli import output_path, parser


def build_scene() -> GaussianSoA:
    soa = GaussianSoA.zeros(3)
    soa.pos[:] = [[-1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]
    soa.color[:] = [[255, 0, 0, 255], [0, 255, 0, 255], [0, 0, 255, 255]]
    soa.scale[:] = 0.3
    return soa


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("out", nargs="?")
    args = p.parse_args(argv)
    scene = GaussiansBuffer.new(build_scene(),
                                device=args.device).download_gaussians()
    with output_path(args.out, "model.ply") as path:
        scene.to_ply().write_to_file(path)
        back = GaussianSoA.from_ply(read_ply(str(path)))
        if not np.array_equal(back.pos, scene.pos):
            raise RuntimeError(f"{path} did not read back")
        print(f"wrote {len(scene)} gaussians to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
