"""The core path on the CPU: a GaussiansBuffer of each of the 12 layouts
unpacked through the layout-specialised bundle (ops/unpack_bundle.py)
against the JAX package's ``unpack_*`` and ``model_to_world`` on the same
packed arrays (atol = rtol = 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu.ops import transforms as jtr
from wgpu_3dgs_core_tpu_torch.convert import buffer_from_packed
from wgpu_3dgs_core_tpu_torch.ops import unpack_bundle as ub

from .common import gaussians_soa
from .torch_parity import MATH_TOL, nn, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("layout", J.ALL_LAYOUTS,
                         ids=lambda l: f"{l.sh.name}-{l.cov3d.name}")
def test_gaussian_unpack_via_bundle(layout):
    """The core path on the CPU: a buffer of each layout unpacked through
    the layout-specialised bundle (world position under a model transform,
    rgba, sh, sigma6), against the JAX package's unpack_* and
    model_to_world on the same packed arrays (1e-6); the plain launcher
    equals the port's plain unpack bit for bit."""
    soa = gaussians_soa()
    jpacked = J.GaussiansBuffer.new(soa, layout).download_packed()
    buf = buffer_from_packed(jpacked, device="cpu")
    mt = T.ModelTransform(pos=(0.3, -0.2, 0.5), rot=(0.1, 0.2, 0.3, 0.927),
                          scale=(1.2, 0.8, 1.1))
    bundle = ub.unpack_bundle(buf, mt)
    assert bundle.cuda_source(len(buf)) == ub.unpack_source(buf.layout, mt)
    got = bundle.dispatch(len(buf))
    d = buf.data
    for a, b in zip(got, ub.unpack_plain(d.pos, d.color, d.sh, d.cov3d,
                                         buf.layout, mt)):
        assert torch.equal(a, b)
    n = len(soa)
    jmt = [jnp.asarray(np.float32(v)) for v in (mt.pos, mt.rot, mt.scale)]
    want = (
        jtr.model_to_world(*jmt, jnp.asarray(jpacked.pos)),
        jtr.unpack_color(jnp.asarray(jpacked.color)),
        jtr.unpack_sh(None if jpacked.sh is None
                      else jnp.asarray(jpacked.sh), n).reshape(n, 45),
        jtr.unpack_cov3d(jnp.asarray(jpacked.cov3d),
                         layout.cov3d == J.Cov3dFormat.ROT_SCALE),
    )
    for name, a, b in zip(("world", "rgba", "sh", "sigma6"), got, want):
        np.testing.assert_allclose(nn(a), np.asarray(b), err_msg=name,
                                   **MATH_TOL)
