"""Inputs of a cell, made from the seed: the scene and the cameras.

The scene is the port bench's synthetic cloud (``synthetic_scene``: means
uniform over a slab, unit quaternions from a normal draw, scales uniform,
colour uniform, opacity in [0.2, 0.9], SH rest bands 0.1 times a normal),
drawn here on the device by a ``torch.Generator`` in a few large calls.
The same seed gives the same scene on the same device. Cameras look at
the scene's centre from a ring, as a capture orbits its subject.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.render import View


def draw_scene(cfg: dict, seed: int, device) -> dict:
    """The scene of configuration ``cfg``: means [N, 3], unit quats [N, 4]
    (x, y, z, w), scales [N, 3], colour [N, 3], opacity [N], sh [N, 15,
    3], all float32 on ``device``; and ``target_colour`` and
    ``target_sh``, the same geometry's colour and SH drawn again (the
    training targets' scene)."""
    n = int(cfg["gaussians"])
    s = cfg["scene"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    half = torch.tensor(s["half_extent"], dtype=torch.float32, device=device)
    means = (torch.rand((n, 3), generator=gen, device=device) * 2 - 1) * half
    quats = torch.randn((n, 4), generator=gen, device=device)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    scales = uniform((n, 3), s["scale_lo"], s["scale_hi"])
    colour = torch.rand((n, 3), generator=gen, device=device)
    opacity = uniform((n,), s["opacity_lo"], s["opacity_hi"])
    sh = torch.randn((n, 15, 3), generator=gen, device=device) * s["sh_std"]
    target_colour = torch.rand((n, 3), generator=gen, device=device)
    target_sh = (torch.randn((n, 15, 3), generator=gen, device=device)
                 * s["sh_std"])
    return dict(means=means, quats=quats, scales=scales, colour=colour,
                opacity=opacity, sh=sh, target_colour=target_colour,
                target_sh=target_sh)


def look_at(eye, width: int, height: int, fov_y: float, near: float,
            far: float) -> View:
    """A camera at ``eye`` looking at the origin, y up, camera z forward
    (depth), x right, y down."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])
    view = np.eye(4)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    f = height / (2.0 * math.tan(fov_y / 2.0))
    return View(view=view.astype(np.float32), fx=float(f), fy=float(f),
                width=int(width), height=int(height), near=float(near),
                far=float(far))


def orbit_view(cfg: dict, traffic: dict, azimuth_deg: float,
               elevation_deg: float) -> View:
    """The camera on the traffic's ring at (azimuth, elevation) in
    degrees; azimuth 0, elevation 0 is the port bench's camera at
    (0, 0, -radius)."""
    r = float(traffic["radius"])
    az, el = math.radians(azimuth_deg), math.radians(elevation_deg)
    eye = (r * math.sin(az) * math.cos(el), -r * math.sin(el),
           -r * math.cos(az) * math.cos(el))
    return look_at(eye, cfg["width"], cfg["height"], traffic["fov_y"],
                   traffic["near"], traffic["far"])


def port_camera(view: View):
    """The port's camera of the same numbers."""
    from wgpu_3dgs_core_tpu_torch.render.camera import Camera

    return Camera(view=tuple(map(tuple, np.asarray(view.view, np.float32)
                                 .tolist())),
                  fx=view.fx, fy=view.fy, width=view.width,
                  height=view.height, near=view.near, far=view.far)
