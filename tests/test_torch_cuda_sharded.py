"""The torch port's sharded renderer on the card (marker ``cuda``): D=1
under NCCL in this process, bit for bit ``render`` with K1-K6 launched on
its path; D=2 ranks sharing the one card under gloo (NCCL takes no two
ranks on one card), spawned by ``parallel/launch.py``, on a mid scene
(65,536 gaussians, 512x512): the image within 1e-5 of ``render``, the
gradients within 1e-4 normalized, each rank's K1-K6 launched, two
backward passes bit-identical.

These need a CUDA card and nvcc, and skip without one. On a machine with
a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_sharded.py``. ``chip_smoke.py`` phases 20-21 run
the same at the bench scene's size.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu_torch.ops.transforms import cov3d_from_rot_scale
from wgpu_3dgs_core_tpu_torch.parallel import (
    initialize_multihost,
    make_mesh,
    render_sharded,
)
from wgpu_3dgs_core_tpu_torch.parallel.launch import (
    free_port,
    render_step,
    spawn_ranks,
)

from .test_torch_cuda import RENDER_KERNELS, cuda  # noqa: F401 (fixture)

pytestmark = pytest.mark.cuda

N, W, H = 65_536, 512, 512
CAM = T.Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                       width=W, height=H, fov_y=0.9)
BG = (0.1, 0.2, 0.3)


def _mid_scene(seed=0):
    """chip_smoke.py's mid scene (bench.py's box of means and scales) as
    numpy: means, sigma6, colour, opacity, sh."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-h, h, N) for h in (3.0, 1.8, 2.0)],
                     axis=1).astype(np.float32)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = rng.uniform(0.004, 0.012, (N, 3)).astype(np.float32)
    cov6 = cov3d_from_rot_scale(torch.from_numpy(q),
                                torch.from_numpy(scales)).numpy()
    color = rng.random((N, 3)).astype(np.float32)
    opac = (0.2 + 0.7 * rng.random(N)).astype(np.float32)
    sh = (0.1 * rng.normal(size=(N, 15, 3))).astype(np.float32)
    return [means, cov6, color, opac, sh]


def _render_grads(x, **kw):
    res = T.render(*x[:4], CAM, sh=x[4], sh_deg=3, background=BG, **kw)
    return res, torch.autograd.grad(torch.mean(res.image ** 2), x)


def _leaves(scene, device):
    return [torch.from_numpy(a).to(device).requires_grad_(True)
            for a in scene]


def test_one_rank_nccl_matches_render_bit_for_bit(cuda):
    scene = _mid_scene()
    x = _leaves(scene, cuda)
    want_res, want = _render_grads(x)
    initialize_multihost(f"localhost:{free_port()}", 1, 0,
                         local_device_ids=[cuda.index], backend="nccl")
    try:
        mesh = make_mesh()
        T.reset_launch_counts()
        res = render_sharded(*x[:4], CAM, mesh, sh=x[4], sh_deg=3,
                             background=BG)
        grads = torch.autograd.grad(torch.mean(res.image ** 2), x)
        torch.cuda.synchronize()
        launches = T.launch_counts()
    finally:
        dist.destroy_process_group()
    assert all(launches[k] >= 1 for k in RENDER_KERNELS), launches
    assert not bool(res.overflow)
    assert torch.equal(res.image, want_res.image)
    assert torch.equal(res.transmittance, want_res.transmittance)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


def test_two_ranks_gloo_on_card_match_render(cuda):
    scene = _mid_scene()
    want_res, want = _render_grads(_leaves(scene, cuda))
    out = [o[0] for o in spawn_ranks(
        render_step, 2, (scene, CAM, [dict(sh_deg=3, background=BG)],
                         None, True),
        backend="gloo", device="cuda", timeout=300.0)]
    for it in out:
        assert not it["overflow"] and it["identical"]
        assert all(it["launches"][k] >= 1 for k in RENDER_KERNELS)
        assert torch.equal(it["image"], out[0]["image"])
    err = float((out[0]["image"] - want_res.image.detach().cpu()).abs().max())
    assert err <= 1e-5
    for k, w in enumerate(want):
        got = torch.cat([it["grads"][k] for it in out])
        w = w.cpu()
        assert float((got - w).abs().max() / w.abs().max()) <= 1e-4
