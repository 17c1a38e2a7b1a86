"""Fit gaussians to a target image with the differentiable renderer
(the repo's examples/fit_scene.py).

Renders a target from the example scene, perturbs the scene, then
recovers it by gradient descent: the training path (projection, binning,
the forward and backward kernels, Adam).

Usage: python -m wgpu_3dgs_core_tpu_torch.examples.fit_scene [--steps N]
           [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from wgpu_3dgs_core_tpu_torch import (
    Camera,
    GaussiansBuffer,
    GaussianSoA,
    fit,
    read_ply,
    render_gaussians,
)

from ._cli import MODEL_PLY, parser


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--steps", type=int, default=100)
    args = p.parse_args(argv)
    soa = GaussianSoA.from_ply(read_ply(str(MODEL_PLY)))
    cam = Camera.look_at(eye=(0, -0.5, -4), target=(0, 0, 0), width=64,
                         height=64, fov_y=0.9)
    target = render_gaussians(GaussiansBuffer.new(soa, device=args.device),
                              cam).image
    perturbed = GaussianSoA(
        rot=soa.rot,
        pos=soa.pos + np.random.default_rng(0).normal(0, 0.2, soa.pos.shape),
        color=soa.color,
        sh=soa.sh,
        scale=soa.scale * 1.5,
    )
    fitted, losses = fit(perturbed, cam, target, steps=args.steps,
                         learning_rate=1e-2, sh_deg=0, log_every=10)
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f} over {args.steps} "
          f"steps on {target.device}")
    print(f"mean position error: {np.abs(fitted.pos - soa.pos).mean():.4f} "
          f"(started {np.abs(perturbed.pos - soa.pos).mean():.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
