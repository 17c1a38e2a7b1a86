"""The N-scale autograd (projection and SH colour) by piece on the card.

The counterpart of ``tools/bench_nscale.py``: the device time of the
backward of each piece of the autograd that runs outside the
rasterizer's Function, each the ``torch.autograd.grad`` of the JAX
tool's loss for that piece (its forward included, as the JAX tool's):

- ``sh_bwd[N,15,3]``: sum(rgb * 1e-6) of ``gaussian_color`` in the
  port's layout, w.r.t. (colour, sh, means);
- ``sh_bwd[45,N]``: the same colour at sh_deg 3 through attribute-major
  inputs (colour [3, N], sh [45, N] coefficient-major, means [3, N]);
- ``proj_bwd``: sum(xy * 1e-6) + sum(conic * 1e-7) + sum(depth * 1e-6)
  of ``project`` w.r.t. (means, cov6): the port's projection takes the
  opacity only into the binning extent, detached, so it has no gradient
  there (the JAX tool's is zeros);
- ``table_bwd(all)``: ``tools/bench_bwd.py``'s ``nscale``.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_nscale \\
        [--gaussians 1000000] [--sh-deg 3] [--iters 10] [--device cuda]

Prints a line per piece, then one JSON line naming the device
(``tools/stages.py``). Reads on a CUDA card only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.projection import camera_position, project
from ..ops.sh import SH_C1, SH_C2, SH_C3, gaussian_color
from ..ops.transforms import device_constant
from ..render.reference import view_dirs
from . import bench_bwd
from .stages import (
    bench_parser,
    bench_setup,
    read_stages,
    report,
    require_card,
)


def sh_color_t(color_t, sh_t, means_t, camera):
    """``gaussian_color`` (sh_deg 3) on attribute-major inputs: colour
    [3, N], sh [45, N] (coefficient k, channel c at row 3 k + c), means
    [3, N]; rgb [3, N]."""
    cam = device_constant(camera_position(camera), means_t.device)
    d = means_t - cam[:, None]
    d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=0,
                                                     keepdim=True), 1e-12)
    x, y, z = d[0], d[1], d[2]

    def c(k):
        return sh_t[3 * k:3 * k + 3]

    res = SH_C1 * (-y * c(0) + z * c(1) - x * c(2))
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    res = res + (
        SH_C2[0] * xy * c(3) + SH_C2[1] * yz * c(4)
        + SH_C2[2] * (2.0 * zz - xx - yy) * c(5)
        + SH_C2[3] * xz * c(6) + SH_C2[4] * (xx - yy) * c(7)
    )
    res = res + (
        SH_C3[0] * y * (3.0 * xx - yy) * c(8)
        + SH_C3[1] * xy * z * c(9)
        + SH_C3[2] * y * (4.0 * zz - xx - yy) * c(10)
        + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * c(11)
        + SH_C3[4] * x * (4.0 * zz - xx - yy) * c(12)
        + SH_C3[5] * z * (xx - yy) * c(13)
        + SH_C3[6] * x * (xx - 3.0 * yy) * c(14)
    )
    return torch.clamp_min(color_t + res, 0.0)


def stages(params, camera, sh_deg: int) -> dict:
    """The four pieces on ``params`` (five leaves requiring grad): each a
    call returning its gradients."""
    means, cov6, color, opac, sh = params
    n = means.shape[0]
    transposed = [t.detach().reshape(n, -1).T.contiguous().requires_grad_(
        True) for t in (color, sh, means)]

    def sh_bwd():
        rgb = gaussian_color(color, sh, view_dirs(means, camera), sh_deg)
        return torch.autograd.grad(torch.sum(rgb * 1e-6), (color, sh, means))

    def sh_bwd_t():
        rgb = sh_color_t(*transposed, camera)
        return torch.autograd.grad(torch.sum(rgb * 1e-6), transposed)

    def proj_bwd():
        s = project(means, cov6, camera, opacity=opac)
        loss = (torch.sum(s.xy * 1e-6) + torch.sum(s.conic * 1e-7)
                + torch.sum(s.depth * 1e-6))
        return torch.autograd.grad(loss, (means, cov6))

    return {
        "sh_bwd[N,15,3]": sh_bwd,
        "sh_bwd[45,N]": sh_bwd_t,
        "proj_bwd": proj_bwd,
        "table_bwd(all)": lambda: bench_bwd.nscale(params, camera, sh_deg),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = require_card(args.device, "bench_nscale")
    params, camera = bench_setup(args, dev)
    todo = stages(params, camera, args.sh_deg)
    return report("bench_nscale", dev, args, read_stages(todo, args.iters))


if __name__ == "__main__":
    main()
