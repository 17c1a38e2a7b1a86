"""Entry points of the port: a forward render on one card, and one
sharded training step over n ranks.

The counterparts of the JAX repo's ``__graft_entry__.py``::

    python -m wgpu_3dgs_core_tpu_torch.entry

renders :func:`entry`'s scene on the card, then runs
:func:`dryrun_multichip` over every card the process sees (NCCL).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.transforms import cov3d_from_rot_scale
from .parallel.launch import spawn_ranks
from .parallel.mesh import make_mesh
from .parallel.sharded import render_sharded
from .render.camera import Camera
from .render.renderer import render

ENTRY_GAUSSIANS = 4096
DRYRUN_GAUSSIANS_PER_RANK = 256
LEARNING_RATE = 1e-3


def _camera(size: int) -> Camera:
    return Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                          width=size, height=size, fov_y=0.9)


def _synthetic_scene(n: int, seed: int = 0) -> list[np.ndarray]:
    """The JAX entry's scene, drawn with numpy: means, sigma6, colour,
    opacity and degree-3 SH (f32)."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = (0.02 + 0.05 * rng.random((n, 3))).astype(np.float32)
    cov6 = cov3d_from_rot_scale(torch.from_numpy(q),
                                torch.from_numpy(scales)).numpy()
    color = rng.random((n, 3)).astype(np.float32)
    opac = (0.2 + 0.7 * rng.random(n)).astype(np.float32)
    sh = (0.1 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    return [means, cov6, color, opac, sh]


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def entry(device=None):
    """(fn, example_args): the forward render of a 4,096-gaussian scene at
    256x256 (sh_deg 3), ``fn(*args)`` -> image [256, 256, 3], on the card
    unless ``device`` says otherwise."""
    dev = _device(device)
    cam = _camera(256)
    args = [torch.from_numpy(a).to(dev)
            for a in _synthetic_scene(ENTRY_GAUSSIANS)]

    def forward(means, cov6, color, opac, sh):
        res = render(means, cov6, color, opac, cam, sh=sh, sh_deg=3,
                     background=(0.0, 0.0, 0.0), max_fragments=65536)
        return res.image

    return forward, args


def _dryrun_rank(rank: int, world: int, device: torch.device) -> float:
    """One rank of :func:`dryrun_multichip`: its shard of the scene, one
    sharded forward + backward of mean(image^2), one SGD step."""
    mesh = make_mesh(world)
    n = DRYRUN_GAUSSIANS_PER_RANK
    scene = _synthetic_scene(n * world)
    params = [torch.from_numpy(a[rank * n:(rank + 1) * n].copy()).to(device)
              .requires_grad_(True) for a in scene]
    cam = _camera(128)
    res = render_sharded(*params[:4], cam, mesh, sh=params[4], sh_deg=3,
                         max_fragments=16384)
    loss = torch.mean(res.image ** 2)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        new = [p - LEARNING_RATE * g for p, g in zip(params, grads)]
    if not (torch.isfinite(loss)
            and all(torch.isfinite(t).all() for t in new)):
        raise RuntimeError(f"rank {rank}: non-finite loss {float(loss)} or "
                           "parameters after the step")
    return float(loss)


def dryrun_multichip(n_devices: int, device=None,
                     backend: Optional[str] = None) -> float:
    """One sharded training step over ``n_devices`` ranks (256 gaussians a
    rank, 128x128, sh_deg 3, all_to_all exchange), each rank a process of
    :func:`~.parallel.launch.spawn_ranks`; returns the loss, checked
    finite and equal on every rank. On the card unless ``device`` is
    ``"cpu"``; ``backend`` defaults to NCCL on the card (a card a rank)
    and gloo on the CPU."""
    dev = _device(device).type
    if backend is None:
        backend = "nccl" if dev == "cuda" else "gloo"
    losses = spawn_ranks(_dryrun_rank, n_devices, backend=backend,
                         device=dev)
    if len(set(losses)) != 1 or not np.isfinite(losses[0]):
        raise RuntimeError(f"ranks disagree on the loss: {losses}")
    return losses[0]


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry() forward ok: image {tuple(out.shape)}, finite: "
          f"{bool(torch.isfinite(out).all())}")
    n = torch.cuda.device_count()
    print(f"dryrun_multichip({n}) ok: loss {dryrun_multichip(n):.6g}")
