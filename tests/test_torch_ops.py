"""Device math of the torch port against the JAX package (atol = rtol =
1e-6): transforms, unpacking, SH and projection on the same numpy inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_core_tpu.ops import projection as jproj
from wgpu_3dgs_core_tpu.ops import sh as jsh
from wgpu_3dgs_core_tpu.ops import transforms as jtr
from wgpu_3dgs_core_tpu.render.camera import Camera as JCamera
from wgpu_3dgs_core_tpu_torch.buffer import ModelTransform
from wgpu_3dgs_core_tpu_torch.convert import camera_from_fields
from wgpu_3dgs_core_tpu_torch.ops import projection as tproj
from wgpu_3dgs_core_tpu_torch.ops import sh as tsh
from wgpu_3dgs_core_tpu_torch.ops import transforms as ttr

from .torch_parity import (  # noqa: F401
    MATH_TOL,
    nn,
    one_torch_thread,
    random_scene,
    tt,
)


def _close(a, b):
    np.testing.assert_allclose(nn(a), nn(b), **MATH_TOL)


@pytest.fixture(scope="module")
def scene():
    return random_scene(64, seed=21)


def test_quat_to_mat3(scene):
    q = scene[1]
    _close(ttr.quat_to_mat3(tt(q)), jtr.quat_to_mat3(jnp.asarray(q)))


def test_cov3d_from_rot_scale(scene):
    _, q, s, *_ = scene
    _close(ttr.cov3d_from_rot_scale(tt(q), tt(s)),
           jtr.cov3d_from_rot_scale(jnp.asarray(q), jnp.asarray(s)))


def test_sigma6_to_mat3(scene):
    s6 = np.random.default_rng(1).normal(size=(16, 6)).astype(np.float32)
    _close(ttr.sigma6_to_mat3(tt(s6)), jtr.sigma6_to_mat3(jnp.asarray(s6)))


@pytest.mark.parametrize("rot_scale,dtype", [
    (True, np.float32), (False, np.float32), (False, np.float16),
])
def test_unpack_cov3d(scene, rot_scale, dtype):
    _, q, s, *_ = scene
    packed = (np.concatenate([q, s], axis=1) if rot_scale
              else np.random.default_rng(2).normal(size=(64, 6)))
    packed = packed.astype(dtype)
    _close(ttr.unpack_cov3d(tt(packed), rot_scale),
           jtr.unpack_cov3d(jnp.asarray(packed), rot_scale))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int8, None])
def test_unpack_sh(dtype):
    rng = np.random.default_rng(3)
    if dtype is None:
        got = ttr.unpack_sh(None, 5, device="cpu")
        want = jtr.unpack_sh(None, 5)
    else:
        width = {np.float32: 45, np.float16: 46, np.int8: 48}[dtype]
        raw = (rng.integers(-128, 128, (5, width)) if dtype == np.int8
               else rng.normal(size=(5, width))).astype(dtype)
        got = ttr.unpack_sh(tt(raw), 5)
        want = jtr.unpack_sh(jnp.asarray(raw), 5)
    _close(got, want)


def test_unpack_color():
    c = np.random.default_rng(4).integers(0, 256, (9, 4)).astype(np.uint8)
    _close(ttr.unpack_color(tt(c)), jtr.unpack_color(jnp.asarray(c)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(scene, deg):
    means, *_, sh = scene
    dirs = means / np.linalg.norm(means, axis=1, keepdims=True)
    _close(tsh.eval_sh(tt(sh), tt(dirs), deg),
           jsh.eval_sh(jnp.asarray(sh), jnp.asarray(dirs), deg))


@pytest.mark.parametrize("no_sh0", [False, True])
def test_gaussian_color(scene, no_sh0):
    means, _, _, color, _, sh = scene
    dirs = means / np.linalg.norm(means, axis=1, keepdims=True)
    _close(tsh.gaussian_color(tt(color), tt(sh), tt(dirs), 3, no_sh0),
           jsh.gaussian_color(jnp.asarray(color), jnp.asarray(sh),
                              jnp.asarray(dirs), 3, no_sh0))


JCAM = JCamera.look_at(eye=(0.5, -1.0, -5.0), target=(0.0, 0.0, 0.0),
                       width=64, height=48, fov_y=0.8)


@pytest.mark.parametrize("antialiased", [False, True])
@pytest.mark.parametrize("model", [False, True])
@pytest.mark.parametrize("with_opacity", [False, True])
def test_project_every_field(scene, antialiased, model, with_opacity):
    means, q, s, _, opac, _ = scene
    cov6 = np.asarray(jtr.cov3d_from_rot_scale(jnp.asarray(q),
                                               jnp.asarray(s)))
    mt = ModelTransform(pos=(0.3, -0.2, 0.5), rot=(0.1, 0.2, 0.3, 0.927),
                        scale=(1.2, 0.8, 1.1))
    kw = dict(size=1.3, radius_cutoff=2.5, antialiased=antialiased)
    cam = camera_from_fields(**dataclasses.asdict(JCAM))
    got = tproj.project(
        tt(means), tt(cov6), cam,
        mt.as_tensors("cpu") if model else None,
        opacity=tt(opac) if with_opacity else None, **kw,
    )
    want = jproj.project(
        jnp.asarray(means), jnp.asarray(cov6), JCAM,
        tuple(jnp.asarray(nn(x)) for x in mt.as_tensors("cpu"))
        if model else None,
        opacity=jnp.asarray(opac) if with_opacity else None, **kw,
    )
    assert got.mask.dtype == torch.bool
    np.testing.assert_array_equal(nn(got.mask), nn(want.mask))
    assert nn(got.mask).sum() > 0
    for name in ("xy", "depth", "conic", "extent", "compensation"):
        np.testing.assert_allclose(nn(getattr(got, name)),
                                   nn(getattr(want, name)), err_msg=name,
                                   **MATH_TOL)


def test_camera_view_matrix_bit_identical():
    cam = camera_from_fields(**dataclasses.asdict(JCAM))
    np.testing.assert_array_equal(nn(cam.view_matrix("cpu")),
                                  np.asarray(JCAM.view_matrix()))
    from wgpu_3dgs_core_tpu_torch import Camera

    mine = Camera.look_at(eye=(0.5, -1.0, -5.0), target=(0.0, 0.0, 0.0),
                          width=64, height=48, fov_y=0.8)
    assert mine == cam
