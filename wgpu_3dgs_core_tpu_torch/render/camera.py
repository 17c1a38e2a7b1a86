"""Pinhole camera, the counterpart of ``wgpu_3dgs_core_tpu.render.camera``.

The same fields and the same numpy construction (``look_at``,
``from_fov``), so both packages build bit-identical view matrices;
:meth:`Camera.view_matrix` returns a float32 tensor on a given device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Camera:
    """Pinhole camera.

    - ``view``: 4x4 world->camera matrix (row-major, applied as ``view @ p``)
    - ``fx, fy``: focal lengths in pixels
    - ``width, height``: image size in pixels
    - ``near, far``: clip depths for frustum culling
    """

    view: tuple  # 4x4 nested tuple so the dataclass stays hashable
    fx: float
    fy: float
    width: int
    height: int
    near: float = 0.01
    far: float = 1000.0

    @property
    def cx(self) -> float:
        return self.width / 2.0

    @property
    def cy(self) -> float:
        return self.height / 2.0

    def view_matrix(self, device="cuda") -> torch.Tensor:
        return torch.tensor(
            np.asarray(self.view, np.float32).reshape(4, 4), device=device
        )

    @property
    def tan_half_fov_x(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tan_half_fov_y(self) -> float:
        return self.height / (2.0 * self.fy)

    @classmethod
    def from_fov(cls, width: int, height: int, fov_y: float, view=None,
                 **kw) -> "Camera":
        """fov_y in radians; fx = fy (square pixels)."""
        fy = height / (2.0 * np.tan(fov_y / 2.0))
        if view is None:
            view = np.eye(4, dtype=np.float32)
        return cls(
            view=tuple(map(tuple, np.asarray(view, np.float32))),
            fx=float(fy),
            fy=float(fy),
            width=width,
            height=height,
            **kw,
        )

    @classmethod
    def look_at(cls, eye, target, up=(0.0, 1.0, 0.0), *, width: int,
                height: int, fov_y: float = 0.9, **kw) -> "Camera":
        """Right-handed look-at with +z pointing from eye toward target
        (camera-space z is depth)."""
        eye = np.asarray(eye, np.float64)
        fwd = np.asarray(target, np.float64) - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        r = np.stack([right, down, fwd])  # world->camera rotation
        t = -r @ eye
        view = np.eye(4)
        view[:3, :3] = r
        view[:3, 3] = t
        return cls.from_fov(width, height, fov_y, view=view, **kw)
