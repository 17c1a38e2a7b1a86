"""The SPZ slice on the card (marker ``cuda``): a seeded scene through an
SPZ round trip on the host (native codec), rendered through K1-K3 on the
card against the same render on the CPU, and the repo's example SPZ
unpacked through K8 against the plain unpack.

These need a CUDA card and nvcc, and skip without one. On a machine with
a card: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_spz.py``
(tests/conftest.py imports jax). chip_smoke.py's phase 22 runs the same
path at 1M gaussians.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu_torch.ops import unpack_bundle as UB
from wgpu_3dgs_core_tpu_torch.utils import native

pytestmark = pytest.mark.cuda

EXAMPLE_SPZ = Path(__file__).resolve().parents[1] / "examples" / "model.spz"
FORWARD_KERNELS = ("expand_row_table", "expand_fragment_records",
                   "sorted_fetch", "rasterize_fwd")
CAM = T.Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                       width=256, height=192, fov_y=0.9)
BG = (0.1, 0.2, 0.3)
IMAGE_ATOL = 3e-5  # the card's exp and FMA contraction differ from the CPU's
N = 8192  # above utils/native.py's MIN_NATIVE_N: the native codec runs


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scene(n=N, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rgba = np.concatenate([rng.random((n, 3)), 0.2 + 0.7 * rng.random((n, 1))],
                          axis=1) * 255.0
    return T.GaussianSoA(
        rot=q,
        pos=rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
        color=rgba.astype(np.uint8),
        sh=(0.1 * rng.normal(size=(n, 15, 3))).astype(np.float32),
        scale=rng.uniform(0.01, 0.05, (n, 3)).astype(np.float32),
    )


def test_spz_round_trip_renders_on_card(cuda, tmp_path):
    assert native.available()
    path = tmp_path / "scene.spz"
    written = T.Gaussians.from_soa(_scene(), T.GaussiansSource.SPZ)
    written.write_to_file(path)
    read = T.Gaussians.read_from_file(path, T.GaussiansSource.SPZ)
    assert read.data == written.data
    soa = read.to_soa()
    kw = dict(background=BG, max_fragments=1 << 17, max_rows=1 << 14)
    transform = T.GaussianTransform(sh_deg=3)
    T.reset_launch_counts()
    got = T.render_gaussians(T.GaussiansBuffer.new(soa, device=cuda), CAM,
                             transform, **kw)
    torch.cuda.synchronize()
    counts = T.launch_counts()
    assert all(counts[k] == 1 for k in FORWARD_KERNELS), counts
    want = T.render_gaussians(T.GaussiansBuffer.new(soa, device="cpu"), CAM,
                              transform, **kw)
    assert not bool(got.overflow) and not bool(want.overflow)
    err = float((got.image.cpu() - want.image).abs().max())
    assert err <= IMAGE_ATOL, err


def test_example_spz_unpacks_through_k8(cuda):
    soa = T.Gaussians.read_from_file(EXAMPLE_SPZ,
                                     T.GaussiansSource.SPZ).to_soa()
    buf = T.GaussiansBuffer.new(soa, T.GaussianLayout(sh=T.ShFormat.NORM8),
                                device=cuda)
    T.reset_launch_counts()
    got = UB.unpack_bundle(buf).dispatch(len(buf))
    torch.cuda.synchronize()
    assert T.launch_counts()["kernel_bundle"] == 1
    d = buf.data
    want = UB.unpack_plain(d.pos, d.color, d.sh, d.cov3d, buf.layout)
    for g, w in zip(got[:3], want[:3]):  # world, rgba, sh: casts
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    # ROT_SCALE sigma: within 1e-6 of each row's largest |sigma|
    # (chip_smoke.py's SIGMA_TOL; csrc/gaussian.cuh rounds as torch does).
    scale = want[3].abs().amax(dim=1, keepdim=True)
    assert float(((got[3] - want[3]).abs() / scale).max()) <= 1e-6
