"""Write a small gaussian scene to compressed SPZ
(the repo's examples/write_spz.py, with its version 2 options).

The scene of write_ply, through a device buffer and back, written to OUT
(default: a temporary directory) and read back.

Usage: python -m wgpu_3dgs_core_tpu_torch.examples.write_spz [out.spz]
           [--device cpu]
"""

from __future__ import annotations

import os
import sys

from wgpu_3dgs_core_tpu_torch import (
    GaussiansBuffer,
    SpzEncodeOptions,
    read_spz,
)

from ._cli import output_path, parser
from .write_ply import build_scene


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("out", nargs="?")
    args = p.parse_args(argv)
    scene = GaussiansBuffer.new(build_scene(),
                                device=args.device).download_gaussians()
    spz = scene.to_spz(SpzEncodeOptions(version=2))
    with output_path(args.out, "model.spz") as path:
        spz.write_to_file(path)
        if read_spz(str(path)) != spz:
            raise RuntimeError(f"{path} did not read back")
        print(f"wrote {len(spz)} gaussians to {path} "
              f"({os.path.getsize(path)} bytes compressed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
