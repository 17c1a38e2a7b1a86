"""Carry the JAX package's parameters across to the port's tensors.

Every function takes plain values and numpy arrays (``np.asarray`` of a JAX
array is one), so both packages can be fed the same inputs and this module
needs no jax. Float arrays keep their dtype bit for bit. Tensors land on
the card unless the caller names another device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .buffer import GaussiansBuffer
from .layouts import Cov3dFormat, GaussianLayout, PackedGaussians, ShFormat
from .render.camera import Camera
from .render.train import TrainableGaussians


def to_tensor(array, device="cuda", dtype: Optional[torch.dtype] = None):
    """numpy (or array-like) -> tensor on ``device``, values unchanged."""
    t = torch.from_numpy(np.array(array, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def gaussians_to_tensors(means, cov3d_sigma6, base_color, opacity, sh=None,
                         device="cuda"):
    """The JAX ``render`` arguments (means [N,3], cov3d_sigma6 [N,6],
    base_color [N,3], opacity [N], optional sh [N,15,3]) as float32
    tensors on ``device``, in that order."""
    f32 = torch.float32
    return (
        to_tensor(means, device, f32),
        to_tensor(cov3d_sigma6, device, f32),
        to_tensor(base_color, device, f32),
        to_tensor(opacity, device, f32),
        None if sh is None else to_tensor(sh, device, f32),
    )


def layout_from_names(sh: str, cov3d: str) -> GaussianLayout:
    """A layout from the JAX layout's format values, e.g.
    ``layout_from_names(jax_layout.sh.value, jax_layout.cov3d.value)``
    ("sh_single", "cov3d_rot_scale", ...)."""
    return GaussianLayout(sh=ShFormat(sh), cov3d=Cov3dFormat(cov3d))


def packed_to_tensors(layout: GaussianLayout, pos, color, sh, cov3d,
                      device="cuda") -> PackedGaussians:
    """The fields of a JAX ``PackedGaussians`` as a packed layout of
    tensors on ``device`` (dtypes kept: f32/u8/f16/i8)."""
    return PackedGaussians(
        layout=layout,
        pos=to_tensor(pos, device),
        color=to_tensor(color, device),
        sh=None if sh is None else to_tensor(sh, device),
        cov3d=to_tensor(cov3d, device),
    )


def buffer_from_packed(packed, device="cuda") -> GaussiansBuffer:
    """A port GaussiansBuffer on ``device`` holding a JAX
    ``PackedGaussians`` (numpy fields, e.g. the JAX buffer's
    ``download_packed()``), values and dtypes unchanged."""
    layout = layout_from_names(packed.layout.sh.value,
                               packed.layout.cov3d.value)
    return GaussiansBuffer(
        packed_to_tensors(layout, packed.pos, packed.color, packed.sh,
                          packed.cov3d, device),
        device,
    )


def camera_from_fields(view, fx, fy, width, height, near=0.01,
                       far=1000.0) -> Camera:
    """A port Camera equal to a JAX Camera with these fields, e.g.
    ``camera_from_fields(**dataclasses.asdict(jax_camera))``."""
    return Camera(
        view=tuple(map(tuple, np.asarray(view, np.float32).reshape(4, 4))),
        fx=float(fx), fy=float(fy), width=int(width), height=int(height),
        near=float(near), far=float(far),
    )


def trainable_from_fields(means, quats, log_scales, color_logit,
                          opacity_logit, sh,
                          device="cuda") -> TrainableGaussians:
    """A port TrainableGaussians equal to a JAX one with these fields (as
    numpy arrays, e.g. ``[np.asarray(x) for x in jax_params]``), on
    ``device``."""
    fields = (means, quats, log_scales, color_logit, opacity_logit, sh)
    return TrainableGaussians(
        *(to_tensor(x, device, torch.float32) for x in fields))
