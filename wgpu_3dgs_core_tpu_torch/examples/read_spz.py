"""Read an SPZ scene and upload it to a device buffer
(the repo's examples/read_spz.py).

Usage: python -m wgpu_3dgs_core_tpu_torch.examples.read_spz [model.spz]
           [--device cpu]
"""

from __future__ import annotations

import sys

from wgpu_3dgs_core_tpu_torch import GaussiansBuffer, GaussianSoA, read_spz

from ._cli import MODEL_SPZ, parser


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("path", nargs="?", default=str(MODEL_SPZ))
    args = p.parse_args(argv)
    spz = read_spz(args.path)
    soa = GaussianSoA.from_spz(spz)
    buf = GaussiansBuffer.new(soa, device=args.device)
    print(f"loaded {len(buf)} gaussians (SPZ v{spz.header.version}, "
          f"SH degree {spz.header.sh_degree}) onto {buf.device}")
    print(f"first position: {soa.pos[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
