"""The torch port's forward slice against the JAX package's renderer.

``render`` and ``render_gaussians`` of the port, on the CPU (plain kernel
versions), against the JAX ``render`` (Pallas kernels in interpret mode)
on the same numpy inputs: 3e-5 max abs on images (the JAX suite's bar,
tests/test_render.py), 1e-4 on the alpha-0.99 opaque chain (its bar for
that case). Overflow parity is in tests/test_torch_binning.py. Last, the
port's measured capacities, which count what ``render`` bins in each
display mode (a deliberate divergence: the JAX package's ``measure_*``
count SPLAT's opacity-culled stream in every mode), and ``fit``'s single
measuring projection.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu.ops.transforms import cov3d_from_rot_scale
from wgpu_3dgs_core_tpu.ops.transforms import unpack_color, unpack_cov3d
from wgpu_3dgs_core_tpu_torch.convert import (
    camera_from_fields,
    gaussians_to_tensors,
)

from .torch_parity import (  # noqa: F401
    CHAIN_ATOL,
    EXAMPLE_PLY,
    IMAGE_ATOL,
    nn,
    one_torch_thread,
    random_scene,
)

JCAM = J.Camera.look_at(eye=(0, 0, -5), target=(0, 0, 0), width=64,
                        height=48, fov_y=0.8)
CAM = camera_from_fields(**dataclasses.asdict(JCAM))
BG = (0.1, 0.2, 0.3)


@functools.partial(jax.jit, static_argnames=("camera", "kw"))
def _jax_render(means, cov6, color, opac, sh, camera, kw):
    return J.render(means, cov6, color, opac, camera, sh=sh, **dict(kw))


_jax_reference = jax.jit(
    J.render_reference,
    static_argnames=("camera", "sh_deg", "background", "display_mode",
                     "pixel_window"),
)


def _both(args, jcam=JCAM, **kw):
    """Render the same numpy inputs with both packages (sh may be None)."""
    m, c, co, o, s = gaussians_to_tensors(*args, device="cpu")
    cam = camera_from_fields(**dataclasses.asdict(jcam))
    mine = T.render(m, c, co, o, cam, sh=s, **kw)
    ref = _jax_render(*args, jcam, tuple(sorted(kw.items())))
    return mine, ref


def _assert_same(mine, ref, atol):
    np.testing.assert_allclose(nn(mine.image), nn(ref.image), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(nn(mine.transmittance),
                               nn(ref.transmittance), atol=atol, rtol=0)
    assert bool(mine.overflow) == bool(ref.overflow)


def _cov6(quats, scales):
    return np.asarray(cov3d_from_rot_scale(jnp.asarray(quats),
                                           jnp.asarray(scales)))


@pytest.fixture(scope="module")
def scene30():
    means, quats, scales, color, opac, sh = random_scene(30, seed=0)
    return means, _cov6(quats, scales), color, opac, sh


@pytest.mark.parametrize("mode", [1, 2])
def test_render_matches_jax_display_modes(scene30, mode):
    """ELLIPSE and POINT; SPLAT is the model.ply case below."""
    mine, ref = _both(scene30, sh_deg=3, background=BG,
                      display_mode=T.GaussianDisplayMode(mode))
    _assert_same(mine, ref, IMAGE_ATOL)
    assert not bool(mine.overflow)
    assert mine.image.shape == (48, 64, 3)
    assert (nn(mine.transmittance) < 0.5).any()  # the scene is visible


@pytest.mark.parametrize("mode,window", [(0, None), (1, None),
                                         (2, (8, 4, 40, 24))])
def test_render_reference_matches_jax(scene30, mode, window):
    """The brute-force spec renderer, which chip_smoke.py holds the slice
    to on the card, against the JAX package's; ``pixel_window`` crops."""
    args = gaussians_to_tensors(*scene30, device="cpu")
    kw = dict(sh_deg=3, background=BG, display_mode=mode,
              pixel_window=window)
    mine = T.render_reference(*args[:4], CAM, sh=args[4], **kw)
    ref = _jax_reference(*scene30[:4], camera=JCAM, sh=scene30[4], **kw)
    np.testing.assert_allclose(nn(mine), nn(ref), atol=IMAGE_ATOL, rtol=0)


def test_opaque_chain_matches_jax():
    """tests/test_render.py::test_forward_opaque_chain_precision's scene:
    stacked alpha-0.99 fragments, the JAX kernel's worst cumsum case."""
    n = 120
    rng = np.random.default_rng(11)
    means = np.concatenate([rng.normal(scale=0.2, size=(n, 2)),
                            rng.uniform(-1.0, 1.0, (n, 1))],
                           axis=1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats = quats / np.linalg.norm(quats, axis=1, keepdims=True)
    scales = (0.1 + 0.1 * rng.random((n, 3))).astype(np.float32)
    color = rng.random((n, 3)).astype(np.float32)
    opac = np.full((n,), 0.999, np.float32)
    mine, ref = _both((means, _cov6(quats, scales), color, opac, None),
                      background=BG)
    assert not bool(mine.overflow)
    assert (nn(mine.transmittance) < 1e-3).any()  # saturated pixels
    _assert_same(mine, ref, CHAIN_ATOL)


@pytest.fixture(scope="module")
def model_soa():
    """examples/model.ply, given nonzero rest SH (its own are all zero) so
    that sh_deg 3 changes the image."""
    mine = T.GaussianSoA.from_ply(T.read_ply(EXAMPLE_PLY))
    ref = J.GaussianSoA.from_ply(J.read_ply(str(EXAMPLE_PLY)))
    sh = 0.3 * np.random.default_rng(0).normal(size=mine.sh.shape)
    mine.sh[:] = sh
    ref.sh[:] = sh
    return mine, ref


MODEL_JCAM = J.Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=80,
                              height=64, fov_y=0.9)


@pytest.mark.parametrize("cov3d", ["ROT_SCALE", "SINGLE", "HALF"])
def test_render_gaussians_model_ply_matches_jax(model_soa, cov3d):
    """examples/model.ply through GaussiansBuffer.new and render_gaussians
    (SPLAT, sh_deg 3, SH stored f32), against the JAX render_gaussians: the
    JAX side unpacks the same layout and renders with JAX ``render``."""
    mine_soa, ref_soa = model_soa
    layout = T.GaussianLayout(cov3d=T.Cov3dFormat[cov3d])
    jlayout = J.GaussianLayout(cov3d=J.Cov3dFormat[cov3d])
    buf = T.GaussiansBuffer.new(mine_soa, layout, device="cpu")
    mine = T.render_gaussians(
        buf, camera_from_fields(**dataclasses.asdict(MODEL_JCAM)),
        T.GaussianTransform(sh_deg=3), background=BG,
    )
    packed = J.pack(ref_soa, jlayout)
    cov6 = unpack_cov3d(jnp.asarray(packed.cov3d),
                        rot_scale=cov3d == "ROT_SCALE")
    color = unpack_color(jnp.asarray(packed.color))
    ref = _jax_render(
        jnp.asarray(packed.pos), cov6, color[:, 0:3], color[:, 3],
        jnp.asarray(packed.sh[:, :45].reshape(-1, 15, 3)), MODEL_JCAM,
        (("background", BG), ("sh_deg", 3)),
    )
    assert (nn(mine.transmittance) < 0.9).any()
    _assert_same(mine, ref, IMAGE_ATOL)


def test_render_tracks_grad_only_when_asked(scene30):
    """Inputs that require grad give an image with a grad_fn, through the
    binned rasterization's autograd Function; under no_grad, none."""
    means, cov6, color, opac, sh = gaussians_to_tensors(*scene30,
                                                        device="cpu")
    opac.requires_grad_(True)
    res = T.render(means, cov6, color, opac, CAM)
    assert res.image.grad_fn is not None
    assert not res.overflow.requires_grad
    with torch.no_grad():
        res = T.render(means, cov6, color, opac, CAM)
    assert res.image.grad_fn is None and not res.image.requires_grad


def _faint_scene():
    """4,000 faint gaussians (opacity 0.1, scales 0.05-0.12), seed 0, whose
    ELLIPSE stream (the whole flat ring, no opacity cull) is longer than
    the SPLAT stream the opacity cull trims."""
    rng = np.random.default_rng(0)
    n = 4000
    means = rng.normal(size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = rng.uniform(0.05, 0.12, (n, 3)).astype(np.float32)
    color = rng.random((n, 3)).astype(np.float32)
    opac = np.full(n, 0.1, np.float32)
    return gaussians_to_tensors(means, _cov6(q, scales), color, opac, None,
                                device="cpu")[:4]


def test_measured_capacities_follow_the_display_mode():
    """At headroom 1.0 (counts rounded up only), each mode renders without
    overflow at the capacities measured for it; SPLAT's are the counts the
    parent measured for every mode, with which ELLIPSE overflowed."""
    means, cov6, color, opac = _faint_scene()
    cam = T.Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                           width=160, height=96, fov_y=0.9)
    splat = T.measure_capacities(means, cov6, opac, cam, headroom=1.0)
    assert splat == (8960, 6144)
    assert (T.measure_max_fragments(means, cov6, opac, cam, headroom=1.0),
            T.measure_max_rows(means, cov6, opac, cam, headroom=1.0)) == splat
    ellipse = T.measure_capacities(
        means, cov6, opac, cam, headroom=1.0,
        display_mode=T.GaussianDisplayMode.ELLIPSE)
    assert ellipse[0] > splat[0]
    for mode, caps, overflow in (
        (T.GaussianDisplayMode.SPLAT, splat, False),
        (T.GaussianDisplayMode.ELLIPSE, splat, True),
        (T.GaussianDisplayMode.ELLIPSE, ellipse, False),
    ):
        res = T.render(means, cov6, color, opac, cam, display_mode=mode,
                       max_fragments=caps[0], max_rows=caps[1])
        assert bool(res.overflow) == overflow, (mode, caps)


def test_fit_measures_with_one_projection(monkeypatch):
    """``fit`` sizes both capacities from one projection pass, for the
    display mode it renders in."""
    from wgpu_3dgs_core_tpu_torch.render import renderer, train

    calls = []
    project = renderer.project
    monkeypatch.setattr(renderer, "project",
                        lambda *a, **kw: calls.append(kw) or project(*a,
                                                                      **kw))
    seen = {}
    make_step = train.make_train_step

    def spy(camera, target, opt, **kw):
        seen.update(kw)
        return make_step(camera, target, opt, **kw)

    monkeypatch.setattr(train, "make_train_step", spy)
    rng = np.random.default_rng(1)
    soa = T.GaussianSoA(
        rot=rng.normal(size=(50, 4)), pos=rng.normal(size=(50, 3)),
        color=rng.integers(20, 230, (50, 4)), sh=np.zeros((50, 15, 3)),
        scale=rng.uniform(0.05, 0.2, (50, 3)))
    target = torch.zeros((48, 64, 3))
    T.fit(soa, CAM, target, steps=0,
          display_mode=T.GaussianDisplayMode.ELLIPSE)
    assert len(calls) == 1 and calls[0]["opacity"] is None  # ELLIPSE's
    assert seen["display_mode"] == T.GaussianDisplayMode.ELLIPSE
    assert seen["max_fragments"] >= 1024 and seen["max_rows"] >= 1024
