"""The torch port's render under the GaussianTransform knobs against the
JAX package's brute-force ``render_reference``.

The sweeps of tests/test_display_modes.py: ``max_std_dev`` {1, 2, 3},
``size`` {0.5, 1, 2} and ``antialiased`` on splats scaled by 0.1, each
image within 3e-5 of the JAX jnp reference (the JAX suite's bar); and
the gradients of sum((image - target)^2) under the size, cutoff and
antialiased knobs against jax.grad of the same reference, within 1e-4
of each parameter's largest (tests/test_render.py's bar). The port
renders through its tiled path (the kernels' plain versions on the
CPU); the jnp reference keeps the JAX side free of interpret-mode
compiles.
"""

import functools

import jax
import numpy as np
import pytest

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu.ops.transforms import cov3d_from_rot_scale

from .test_torch_backward import (
    CAM,
    JCAM,
    _assert_grads,
    _jax_reference_grads,
    _l2,
    _port_grads,
)
from .torch_parity import IMAGE_ATOL, nn, one_torch_thread, random_scene, tt  # noqa: F401

BG = (0.1, 0.2, 0.3)


@functools.partial(jax.jit, static_argnames=("kw",))
def _jax_image(means, cov6, color, opac, kw):
    return J.render_reference(means, cov6, color, opac, JCAM, **dict(kw))


IMAGE_CASES = ([(("max_std_dev", v),) for v in (1.0, 2.0, 3.0)]
               + [(("size", v),) for v in (0.5, 1.0, 2.0)]
               + [(("antialiased", True),)])


@pytest.mark.parametrize("knob", IMAGE_CASES,
                         ids=lambda k: f"{k[0][0]}={k[0][1]}")
def test_knob_images_match_jax_reference(knob):
    """tests/test_display_modes.py's scenes: 20 gaussians, seed 7 (seed 11
    and scales x 0.1 for antialiased, where the opacity compensation is
    strongest), 64x48, the port's tiled render against the JAX jnp
    reference."""
    antialiased = knob[0][0] == "antialiased"
    means, quats, scales, color, opac, _ = random_scene(
        20, seed=11 if antialiased else 7)
    if antialiased:
        scales = scales * np.float32(0.1)
    cov6 = np.asarray(cov3d_from_rot_scale(quats, scales))
    kw = (("background", BG),) + knob
    ref = np.asarray(_jax_image(means, cov6, color, opac, kw))
    res = T.render(tt(means), tt(cov6), tt(color), tt(opac), CAM, **dict(kw))
    assert not bool(res.overflow)
    np.testing.assert_allclose(nn(res.image), ref, atol=IMAGE_ATOL, rtol=0)
    if antialiased:  # the compensation lowers small splats' opacity
        plain = T.render(tt(means), tt(cov6), tt(color), tt(opac), CAM,
                         background=BG)
        assert (nn(res.transmittance).mean()
                > nn(plain.transmittance).mean())


@pytest.mark.parametrize("knob", [
    (("size", 1.7),),
    (("max_std_dev", 2.0),),
    (("antialiased", True),),
], ids=["size", "max_std_dev", "antialiased"])
def test_knob_gradients_match_jax_reference(knob):
    """The port's render gradients w.r.t. (means, quats, scales, color,
    opacity, sh) under one knob, on the 20-gaussian scene at sh_deg 3,
    against jax.grad of the JAX render_reference."""
    args = random_scene(20, seed=2)
    target = np.random.default_rng(3).random((48, 64, 3)).astype(np.float32)
    kw = (("background", BG), ("sh_deg", 3)) + knob
    ref = _jax_reference_grads(args, target, kw)
    mine = _port_grads(args, _l2(target), True, **dict(kw))
    _assert_grads(mine, ref)

