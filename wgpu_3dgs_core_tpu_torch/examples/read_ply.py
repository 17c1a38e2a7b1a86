"""Read a PLY scene and upload it to a device buffer
(the repo's examples/read_ply.py).

Usage: python -m wgpu_3dgs_core_tpu_torch.examples.read_ply [model.ply]
           [--device cpu]
"""

from __future__ import annotations

import sys

from wgpu_3dgs_core_tpu_torch import GaussiansBuffer, GaussianSoA, read_ply

from ._cli import MODEL_PLY, parser


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("path", nargs="?", default=str(MODEL_PLY))
    args = p.parse_args(argv)
    soa = GaussianSoA.from_ply(read_ply(args.path))
    buf = GaussiansBuffer.new(soa, device=args.device)
    print(f"loaded {len(buf)} gaussians ({buf.nbytes} bytes on "
          f"{buf.device})")
    print(f"first position: {soa.pos[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
