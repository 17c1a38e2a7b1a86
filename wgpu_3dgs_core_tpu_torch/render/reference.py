"""Brute-force reference renderer: every gaussian blended at every pixel.

The counterpart of ``wgpu_3dgs_core_tpu.render.reference``: the semantic
spec the tiled renderer is held to, O(N * pixels), in plain torch on any
device. Blending semantics (shared with the tiled path):

- alpha_i = min(0.99, opacity_i * exp(-0.5 q_i)), q the conic form
- a fragment contributes iff q <= max_std_dev^2 and alpha >= 1/255
- front to back by camera depth; T_{i+1} = T_i (1 - alpha_i), updated
  only while T_i > 1e-4
- image = sum_i alpha_i T_i c_i + T_final * background
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.projection import camera_position, project
from ..ops.rasterize import ALPHA_CLAMP, ALPHA_MIN, ELLIPSE_RING, blend_weights
from ..ops.sh import gaussian_color, view_dirs_from
from ..ops.transforms import device_constant
from .camera import Camera


def view_dirs(means: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Unit directions [N, 3] from the camera centre to each gaussian."""
    return view_dirs_from(means, camera_position(camera))


class _PointConic(torch.autograd.Function):
    """POINT mode's conic, a constant [N, 3], that keeps the covariance
    it replaces as an input: its gradient there is exact zeros, as
    ``jax.grad`` gives for an input the image does not depend on."""

    @staticmethod
    def forward(ctx, cov3d_sigma6, inv: float):
        ctx.cov_shape = cov3d_sigma6.shape
        return device_constant([inv, 0.0, inv], cov3d_sigma6.device).expand(
            cov3d_sigma6.shape[0], 3)

    @staticmethod
    def backward(ctx, grad):
        return grad.new_zeros(ctx.cov_shape), None


def point_conic(size: float, cov3d_sigma6: torch.Tensor) -> torch.Tensor:
    """POINT display mode: an isotropic dot of ~``size`` pixels std dev for
    each of the gaussians of ``cov3d_sigma6`` [N, 6], which gets a zero
    gradient."""
    pt = max(float(size), 0.5)
    return _PointConic.apply(cov3d_sigma6, 1.0 / (pt * pt))


def render_reference(
    means: torch.Tensor,
    cov3d_sigma6: torch.Tensor,
    base_color: torch.Tensor,
    opacity: torch.Tensor,
    camera: Camera,
    sh: Optional[torch.Tensor] = None,
    sh_deg: int = 0,
    no_sh0: bool = False,
    background: tuple = (0.0, 0.0, 0.0),
    model_transform: Optional[tuple] = None,
    size: float = 1.0,
    max_std_dev: float = 3.0,
    display_mode: int = 0,
    antialiased: bool = False,
    pixel_window: Optional[tuple] = None,
) -> torch.Tensor:
    """Render [H, W, 3] by blending every gaussian at every pixel.

    ``pixel_window``: optional (x0, y0, w, h) crop, evaluated with the same
    blending at those pixels only (projection still uses the full camera).
    """
    h, w_px = camera.height, camera.width
    dev = means.device
    splats = project(means, cov3d_sigma6, camera, model_transform,
                     size=size, radius_cutoff=max_std_dev,
                     antialiased=antialiased)
    opacity = opacity * splats.compensation
    conic = splats.conic
    if display_mode == 2:  # point
        conic = point_conic(size, cov3d_sigma6)

    rgb = gaussian_color(base_color, sh, view_dirs(means, camera), sh_deg,
                         no_sh0)

    # Blend order: depth ascending, culled last, ties by gaussian id.
    depth_key = torch.where(splats.mask, splats.depth, math.inf)
    order = torch.sort(depth_key, stable=True).indices
    xy = splats.xy[order]
    conic = conic[order]
    rgb = rgb[order]
    a = opacity[order] * splats.mask[order]

    x0, y0 = 0, 0
    if pixel_window is not None:
        x0, y0 = int(pixel_window[0]), int(pixel_window[1])
        w_px, h = int(pixel_window[2]), int(pixel_window[3])
    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev), torch.arange(w_px, device=dev),
        indexing="ij",
    )
    px = (xs + x0 + 0.5).float().reshape(-1)  # [P]
    py = (ys + y0 + 0.5).float().reshape(-1)

    dx = px[None, :] - xy[:, 0:1]  # [N, P]
    dy = py[None, :] - xy[:, 1:2]
    q = (conic[:, 0:1] * dx * dx + 2.0 * conic[:, 1:2] * dx * dy
         + conic[:, 2:3] * dy * dy)
    cutoff_sq = float(max_std_dev) ** 2
    # torch.minimum, as jnp.minimum, gives a tie with the clamp half the
    # gradient (clamp_max would give all of it).
    clamp = torch.tensor(ALPHA_CLAMP, device=dev)
    if display_mode == 1:  # ellipse outline: opaque ring at the boundary
        alpha = torch.minimum(a[:, None], clamp).expand_as(q)
        ok = ((q <= cutoff_sq) & (q >= cutoff_sq * ELLIPSE_RING)
              & (alpha >= ALPHA_MIN))
    else:
        alpha = torch.minimum(a[:, None] * torch.exp(-0.5 * q), clamp)
        ok = (q <= cutoff_sq) & (alpha >= ALPHA_MIN)
    alpha = torch.where(ok, alpha, 0.0)

    w, t_final = blend_weights(alpha, dim=0)
    color = w.T @ rgb  # [P, 3]
    bg = device_constant(background, dev)
    img = color + t_final[:, None] * bg
    return img.reshape(h, w_px, 3)
