"""The SH colour of ``ops/sh.py::sh_color`` on the CPU: its plain forward
and the closed-form backward its kernel computes
(``sh_color_bwd_plain``) against autograd through ``gaussian_color`` over
the view directions, and against ``jax.vjp`` of the JAX package's
``gaussian_color`` over its view directions, at sh_deg 1-3 with and
without ``no_sh0``; and ``project_and_color`` on the CPU, unchanged.

The inputs place colour channels exactly at the 0 clamp (base 0 and that
channel's coefficients 0; without ``no_sh0``) and gaussians within the
1e-12 norm clamp's reach of the camera centre. At such a tie torch's
``clamp_min`` passes the whole gradient and JAX's ``maximum`` half of it:
the port follows torch, and the comparison with JAX doubles JAX's gradient
there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_core_tpu.ops.sh import gaussian_color as jax_color
from wgpu_3dgs_core_tpu_torch import Camera
from wgpu_3dgs_core_tpu_torch.ops import sh as S
from wgpu_3dgs_core_tpu_torch.render.reference import view_dirs
from wgpu_3dgs_core_tpu_torch.render.renderer import project_and_color

from .torch_parity import MATH_TOL, nn, one_torch_thread, tt  # noqa: F401

N = 300
# A camera centre near the origin, so that gaussians can lie within 1e-12
# of it in float32.
CAM_POS = (2e-13, -1e-13, 0.0)
NEAR = 3  # gaussians 0..2 lie within the norm clamp's reach
TIES = slice(3, 9)  # gaussians with a colour channel exactly at 0
# Gradients: the ROADMAP's bar, normalized per gaussian by its largest
# entry (the near gaussians' means gradients are ~1e12 times the rest's).
GRAD_TOL = 1e-4


def _inputs(seed=0):
    """(base, sh, means, d_rgb) as numpy float32, the ties and near
    gaussians placed."""
    rng = np.random.default_rng(seed)
    cam = np.array(CAM_POS, np.float32)
    means = rng.normal(size=(N, 3)).astype(np.float32)
    means[:NEAR] = cam + np.array([[3e-13, 1e-13, -2e-13], [5e-13, 0, 0],
                                   [0, -4e-13, 1e-13]], np.float32)
    base = rng.random((N, 3)).astype(np.float32)
    sh = (0.3 * rng.normal(size=(N, 15, 3))).astype(np.float32)
    base[3:6], sh[3:6] = 0.0, 0.0  # every channel tied
    base[6:9, 1], sh[6:9, :, 1] = 0.0, 0.0  # the green channel tied
    # Some colours clamped: a dark base under strong coefficients.
    base[9:60] *= 0.05
    d_rgb = rng.normal(size=(N, 3)).astype(np.float32)
    return base, sh, means, d_rgb


def _row_err(a, b) -> float:
    """The largest difference, each gaussian's normalized by its largest
    entry of ``b`` (1 where that row of ``b`` is zero)."""
    a, b = nn(a).reshape(N, -1), nn(b).reshape(N, -1)
    den = np.abs(b).max(axis=1, keepdims=True)
    return float((np.abs(a - b) / np.where(den > 0, den, 1.0)).max())


def _jax_vjp(base, sh, means, d_rgb, sh_deg, no_sh0):
    cam = jnp.asarray(np.array(CAM_POS, np.float32))

    def color(b, s, m):
        d = m - cam
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True).clip(1e-12)
        return jax_color(b, s, d, sh_deg, no_sh0)

    out, vjp = jax.vjp(color, *map(jnp.asarray, (base, sh, means)))
    return out, vjp(jnp.asarray(d_rgb))


@pytest.mark.parametrize("no_sh0", [False, True])
@pytest.mark.parametrize("sh_deg", [1, 2, 3])
def test_sh_color_plain_and_closed_form(sh_deg, no_sh0):
    base, sh, means, d_rgb = _inputs()
    leaves = [tt(x).requires_grad_(True) for x in (base, sh, means)]
    rgb = S.sh_color(*leaves, CAM_POS, sh_deg, no_sh0)
    # The plain forward is the graph gaussian_color over the directions.
    dirs = S.view_dirs_from(leaves[2], CAM_POS)
    graph = S.gaussian_color(leaves[0], leaves[1], dirs, sh_deg, no_sh0)
    assert torch.equal(rgb, graph)
    d_base, d_sh, d_means = S.sh_color_bwd_plain(
        *(tt(x) for x in (base, sh, means)), CAM_POS, sh_deg, no_sh0,
        tt(d_rgb))
    auto = torch.autograd.grad(rgb, leaves, tt(d_rgb), allow_unused=True)
    if not no_sh0:  # ties and clamps from the base colour
        pre = nn(graph)
        assert (pre[TIES] == 0).any() and (pre[9:60] == 0).any()
    assert np.isfinite(nn(d_means)).all()
    if no_sh0:
        assert auto[0] is None and not d_base.any()
    else:
        assert torch.equal(d_base, auto[0])
    assert _row_err(d_sh, auto[1]) <= GRAD_TOL
    assert _row_err(d_means, auto[2]) <= GRAD_TOL
    assert not d_sh[:, (sh_deg + 1) ** 2 - 1:].any()

    out, (j_base, j_sh, j_means) = _jax_vjp(base, sh, means, d_rgb, sh_deg,
                                            no_sh0)
    np.testing.assert_allclose(nn(rgb), np.asarray(out), **MATH_TOL)
    # JAX halves the gradient of a colour exactly at the clamp.
    unclamped = np.asarray(S.eval_sh(tt(sh), dirs.detach(), sh_deg)) + (
        0.5 if no_sh0 else base)
    tie = np.where(unclamped == 0.0, 2.0, 1.0).astype(np.float32)
    assert (tie > 1).any() != no_sh0
    assert _row_err(d_base, np.asarray(j_base) * tie) <= GRAD_TOL
    assert _row_err(d_sh, np.asarray(j_sh) * tie[:, None, :]) <= GRAD_TOL
    assert _row_err(d_means, j_means) <= GRAD_TOL


def _camera_scene(seed=1, n=64):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    cov6 = np.tile(np.array([0.02, 0, 0, 0.02, 0, 0.02], np.float32),
                   (n, 1))
    color = rng.random((n, 3)).astype(np.float32)
    opac = (0.3 + 0.6 * rng.random(n)).astype(np.float32)
    sh = (0.3 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    cam = Camera.look_at(eye=(0.5, -1.0, -5.0), target=(0.0, 0.0, 0.0),
                         width=64, height=48, fov_y=0.8)
    return [tt(x).requires_grad_(True) for x in (means, cov6, color, opac,
                                                 sh)], cam


@pytest.mark.parametrize("sh_deg", [0, 1, 2, 3])
def test_project_and_color_on_cpu_unchanged(sh_deg):
    """The renderer's colour on the CPU is the graph it was, bit for bit,
    forward and backward: gaussian_color over render/reference.py's
    view_dirs (without SH, sh_deg 0 and no sh tensor)."""
    (means, cov6, color, opac, sh), cam = _camera_scene()
    sh_arg = sh if sh_deg else None
    _, rgb, _ = project_and_color(means, cov6, color, opac, cam, sh=sh_arg,
                                  sh_deg=sh_deg)
    want = S.gaussian_color(color, sh_arg, view_dirs(means, cam), sh_deg)
    assert torch.equal(rgb, want)
    g = torch.linspace(-1.0, 1.0, rgb.numel()).reshape(rgb.shape)
    wrt = (color, means, sh) if sh_deg else (color,)
    for a, b in zip(torch.autograd.grad(rgb, wrt, g),
                    torch.autograd.grad(want, wrt, g)):
        assert torch.equal(a, b)


def test_sh_color_needs_a_degree():
    base, sh, means, _ = (tt(x) for x in _inputs())
    with pytest.raises(ValueError, match="sh_deg"):
        S.sh_color(base, sh, means, CAM_POS, 0)
