"""The torch port's training loop against the JAX package's.

``TrainableGaussians`` (an ``nn.Module``) against the JAX pytree, and
``make_train_step`` with ``torch.optim.Adam`` against the JAX
``make_train_step`` with ``optax.adam``, on tests/test_train.py's scene,
the same numpy inputs on both sides (JAX Pallas kernels in interpret
mode); then ``fit``'s loss-curve contract.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu.render import train as JT
from wgpu_3dgs_core_tpu_torch.convert import (
    camera_from_fields,
    trainable_from_fields,
)

from .common import gaussian_soa_with_seeds
from .test_train import CAM as JCAM
from .test_train import _tiny_scene
from .torch_parity import nn, one_torch_thread, random_scene  # noqa: F401

CAM = camera_from_fields(**dataclasses.asdict(JCAM))
PARAM_TOL = 1e-4  # normalized, as the gradients (tests/test_render.py)
LOSS_RTOL = 1e-5


def _soas(soa):
    """The same scene as a port GaussianSoA."""
    return T.GaussianSoA(rot=soa.rot, pos=soa.pos, color=soa.color,
                         sh=soa.sh, scale=soa.scale)


def test_trainable_round_trip_and_parameterization():
    """from_soa, constrained and to_soa equal the JAX ones (1e-6), and the
    round trip keeps the scene (tests/test_train.py's bars)."""
    soa = gaussian_soa_with_seeds([1, 2])
    soa.color[:] = np.clip(soa.color, 5, 250)  # keep logits finite
    ref = JT.TrainableGaussians.from_soa(soa)
    ref_constrained = jax.jit(JT.TrainableGaussians.constrained)(ref)
    mine = T.TrainableGaussians.from_soa(_soas(soa), device="cpu")
    assert all(isinstance(p, torch.nn.Parameter) for p in mine.parameters())
    assert len(list(mine.parameters())) == 6
    for name in T.TrainableGaussians.FIELDS:
        np.testing.assert_allclose(nn(getattr(mine, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for a, b in zip(mine.constrained(), ref_constrained):
        np.testing.assert_allclose(nn(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    back = mine.to_soa()
    np.testing.assert_allclose(back.pos, soa.pos, atol=1e-5)
    np.testing.assert_allclose(back.scale, soa.scale, rtol=1e-4)
    assert np.abs(back.color.astype(int) - soa.color.astype(int)).max() <= 1


def test_train_steps_match_jax_optax_adam():
    """Three Adam steps of make_train_step from the same parameters and
    target: losses within 1e-5 relative, parameters within 1e-4
    normalized of the JAX step with optax.adam (sh_deg 3)."""
    soa = _tiny_scene()
    soa.sh[:] = 0.1 * np.random.default_rng(1).normal(size=soa.sh.shape)
    target = np.random.default_rng(2).random((32, 32, 3)).astype(np.float32)
    lr = 1e-2

    params = JT.TrainableGaussians.from_soa(soa)
    opt = optax.adam(lr)
    state = opt.init(params)
    jstep = JT.make_train_step(JCAM, jnp.asarray(target), opt, sh_deg=3)
    mine = trainable_from_fields(*(np.asarray(x) for x in params),
                                 device="cpu")
    step = T.make_train_step(CAM, torch.from_numpy(target),
                             torch.optim.Adam(mine.parameters(), lr=lr),
                             sh_deg=3)
    for _ in range(3):
        params, state, jloss, joverflow = jstep(params, state)
        loss, overflow = step(mine)
        assert not bool(overflow) and not bool(joverflow)
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
    for name, ref in zip(T.TrainableGaussians.FIELDS, params):
        ref = np.asarray(ref)
        err = np.abs(nn(getattr(mine, name)) - ref).max() / np.abs(ref).max()
        assert err <= PARAM_TOL, (name, err)


def test_fit_loss_curve_contract():
    """tests/test_train.py's curve: every log_every-th step plus the final
    one; steps=0 -> []. The fit runs where the target lies (here the CPU),
    and a fitted scene comes back finite."""
    scene = _soas(_tiny_scene())
    target = torch.zeros((32, 32, 3))
    fitted, losses = T.fit(scene, CAM, target, steps=8, sh_deg=0,
                           log_every=3)
    assert len(losses) == 4  # steps 0, 3, 6 + final step 7
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert len(fitted) == len(scene) and np.isfinite(fitted.pos).all()
    assert (fitted.scale > 0).all()
    _, losses0 = T.fit(scene, CAM, target, steps=5, sh_deg=0, log_every=0)
    assert len(losses0) == 1  # final only
    _, losses_none = T.fit(scene, CAM, np.zeros((32, 32, 3), np.float32),
                           steps=0, sh_deg=0, device="cpu")
    assert losses_none == []


def test_fit_warns_once_on_overflow():
    """tests/test_render.py::test_overflow_zeroes_gradients' scene (huge
    splats) with a capacity of 256 fragments: every step overflows, so
    the gradients are zero, nothing moves, and fit warns once."""
    means, quats, scales, color, opac, _ = random_scene(50, seed=5)
    rgba = np.concatenate([color, opac[:, None]], axis=1) * 255.0
    scene = T.GaussianSoA(rot=quats, pos=means, scale=scales * 10.0,
                          color=rgba.astype(np.uint8),
                          sh=np.zeros((50, 15, 3), np.float32))
    cam = T.Camera.look_at(eye=(0, 0, -5), target=(0, 0, 0), width=64,
                           height=48, fov_y=0.8)
    with pytest.warns(RuntimeWarning, match="overflow") as rec:
        fitted, losses = T.fit(scene, cam, torch.zeros((48, 64, 3)), steps=3,
                               sh_deg=0, log_every=1, max_fragments=256)
    assert len(rec) == 1 and len(losses) == 3 and losses[0] == losses[-1]
    np.testing.assert_array_equal(fitted.pos, scene.pos)
