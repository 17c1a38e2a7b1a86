"""The torch port's sharded renderer (``wgpu_3dgs_core_tpu_torch.parallel``)
on the CPU, under gloo, against the JAX package and the port's ``render``.

The route (``_route_to_strips``) equals the JAX one bit for bit, overflow
flag included, at D 2, 4 and 8 with capacities that fit and that
overflow (the only place the route can be made to overflow: a whole
render caps the bucket at the shard's length). ``_gather_rows`` gathers
bit for bit and its exact backward is within 1e-6 of ``jax.vjp`` of the
JAX custom VJP. D=1 equals ``render`` bit for bit. At D=2 and D=4, in
both exchange modes, ranks spawned by ``parallel/launch.py``: the image
within 1e-5 of the port's ``render`` and 3e-5 of the JAX jnp
``render_reference``, the gradients of sum((image - target)^2) within
1e-4 of the latter's, normalized by each parameter's largest; the knobs
of ``tests/test_sharded.py`` at D=4 within 1e-5 of ``render``. Then
``initialize_multihost`` in two processes, ``entry()`` and
``dryrun_multichip``. Scenes as ``tests/test_sharded.py::_scene`` makes
them, 64x48.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu.parallel import make_mesh as jax_make_mesh
from wgpu_3dgs_core_tpu.parallel import pad_to_multiple as jax_pad
from wgpu_3dgs_core_tpu.parallel.sharded import (
    _gather_rows as jax_gather_rows,
    _route_to_strips as jax_route,
)
from wgpu_3dgs_core_tpu_torch import entry as E
from wgpu_3dgs_core_tpu_torch.convert import camera_from_fields
from wgpu_3dgs_core_tpu_torch.ops.transforms import cov3d_from_rot_scale
from wgpu_3dgs_core_tpu_torch.parallel import (
    DATA_AXIS,
    gaussian_sharding,
    initialize_multihost,
    make_mesh,
    pad_to_multiple,
    render_sharded,
    replicated,
)
from wgpu_3dgs_core_tpu_torch.parallel import sharded as S
from wgpu_3dgs_core_tpu_torch.parallel.launch import (
    free_port,
    render_step,
    spawn_ranks,
)

from .torch_parity import IMAGE_ATOL, nn, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JCAM = J.Camera.look_at(eye=(0, 0, -5), target=(0, 0, 0), width=64,
                        height=48, fov_y=0.8)
CAM = camera_from_fields(**dataclasses.asdict(JCAM))
BG = (0.1, 0.2, 0.3)
SHARDED_ATOL = 1e-5  # tests/test_sharded.py's bar against render
GRAD_TOL = 1e-4  # normalized by each parameter's largest gradient
SPAWN_TIMEOUT = 120.0  # seconds a spawn of ranks may take
PER_DEVICE_FRAGMENTS = 1024  # a strip's own capacity, a CHUNK multiple


def _scene(n, seed):
    """tests/test_sharded.py::_scene as numpy (sigma6 by the port)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = (0.05 + 0.2 * rng.random((n, 3))).astype(np.float32)
    cov6 = cov3d_from_rot_scale(torch.from_numpy(q),
                                torch.from_numpy(scales)).numpy()
    color = rng.random((n, 3)).astype(np.float32)
    opac = (0.3 + 0.6 * rng.random(n)).astype(np.float32)
    sh = (0.2 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    return [means, cov6, color, opac, sh]


SCENE = _scene(64, seed=1)
TARGET = np.random.default_rng(2).random((48, 64, 3)).astype(np.float32)
MODEL = tuple(np.asarray(v, np.float32) for v in (
    [0.1, -0.05, 0.2], [0.0, 0.1, 0.0, 0.995], [1.1, 0.9, 1.0]))
KNOB_CASES = [
    dict(size=1.7, max_std_dev=2.0, no_sh0=True, model_transform=MODEL,
         antialiased=True),
    dict(display_mode=T.GaussianDisplayMode.ELLIPSE),
    dict(display_mode=T.GaussianDisplayMode.POINT, size=2.0),
]


def _port_render(scene, target=None, **kw):
    """The port's single-device render of a numpy scene, and the
    gradients of sum((image - target)^2) with a target."""
    x = [torch.from_numpy(a).requires_grad_(True) for a in scene]
    res = T.render(*x[:4], CAM, sh=x[4], background=BG, **kw)
    assert not bool(res.overflow)
    if target is None:
        return res, None
    loss = torch.sum((res.image - torch.from_numpy(target)) ** 2)
    return res, torch.autograd.grad(loss, x)


@functools.partial(jax.jit, static_argnames=("kw",))
def _jax_reference(args, target, kw):
    """The JAX jnp render_reference's image and jax.grad of sum((image -
    target)^2) w.r.t. (means, cov3d_sigma6, colour, opacity, sh)."""
    def image(args):
        means, cov6, color, opac, sh = args
        return J.render_reference(means, cov6, color, opac, JCAM, sh=sh,
                                  background=BG, **dict(kw))

    return image(args), jax.grad(
        lambda a: jnp.sum((image(a) - target) ** 2))(args)


@pytest.fixture(scope="module")
def reference():
    img, grads = _jax_reference(tuple(SCENE), TARGET, (("sh_deg", 3),))
    return np.asarray(img), [np.asarray(g) for g in grads]


def _check_ranks(out, reference, case=0):
    """Every rank's replicated image equal, within SHARDED_ATOL of the
    port's render and IMAGE_ATOL of the JAX reference; the shards'
    gradients within GRAD_TOL of the JAX reference's; no overflow."""
    items = [o[case] for o in out]
    img = items[0]["image"]
    for it in items:
        assert torch.equal(it["image"], img)
        assert not it["overflow"] and not it["stats"]["route_overflow"]
        assert it["stats"]["fragments"] <= it["stats"]["f_cap"]
    single, _ = _port_render(SCENE, sh_deg=3)
    np.testing.assert_allclose(nn(img), nn(single.image), rtol=0,
                               atol=SHARDED_ATOL)
    np.testing.assert_allclose(nn(items[0]["transmittance"]),
                               nn(single.transmittance), rtol=0,
                               atol=SHARDED_ATOL)
    ref_img, ref_grads = reference
    np.testing.assert_allclose(nn(img), ref_img, rtol=0, atol=IMAGE_ATOL)
    names = ("means", "cov6", "color", "opac", "sh")
    for k, (name, want) in enumerate(zip(names, ref_grads)):
        got = torch.cat([it["grads"][k] for it in items]).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
    return items


def _route_inputs(n, d, seed):
    """Packed rows and strip ranges: spans of 0-3 strips, some dead."""
    rng = np.random.default_rng(seed)
    packed = rng.normal(size=(n, 13)).astype(np.float32)
    s0 = rng.integers(0, d, n).astype(np.int32)
    s1 = np.minimum(s0 + rng.integers(0, 3, n), d - 1).astype(np.int32)
    s1 = np.where(rng.random(n) < 0.2, s0 - 1, s1).astype(np.int32)
    return packed, s0, s1


def test_route_to_strips_matches_jax():
    """The send buffer and the overflow flag, bit for bit, at D 2, 4 and
    8: buckets that fit (cap = n), buckets that overflow, and an expansion
    past the whole send capacity (total > D * cap)."""
    seen = set()
    for d in (2, 4, 8):
        n = 6 * d
        packed, s0, s1 = _route_inputs(n, d, seed=d)
        for cap in (n, 3, 1):
            want, want_over = jax_route(jnp.asarray(packed), jnp.asarray(s0),
                                        jnp.asarray(s1), d, cap)
            got, over = S._route_to_strips(
                torch.from_numpy(packed), torch.from_numpy(s0),
                torch.from_numpy(s1), d, cap)
            assert got.shape == (d, cap, 13)
            np.testing.assert_array_equal(
                nn(got).view(np.uint32), np.asarray(want).view(np.uint32),
                err_msg=f"D={d} cap={cap}")
            assert bool(over) == bool(want_over), (d, cap)
            seen.add(bool(over))
    assert seen == {False, True}
    # D=1: the identity route, padded, or truncated and flagged.
    packed, s0, s1 = _route_inputs(8, 1, seed=0)
    for cap in (12, 8, 5):
        want, want_over = jax_route(jnp.asarray(packed), None, None, 1, cap)
        got, over = S._route_to_strips(torch.from_numpy(packed), None, None,
                                       1, cap)
        np.testing.assert_array_equal(nn(got), np.asarray(want))
        assert bool(over) == bool(want_over) == (cap < 8)


def test_gather_rows_matches_jax_vjp():
    """Forward bit for bit; the backward within 1e-6 of jax.vjp of the JAX
    custom VJP, equal bit for bit to each source's rows summed in bucket
    order in f32, and bit-identical on a second pass."""
    d, cap, n = 4, 10, 16
    rng = np.random.default_rng(5)
    packed = rng.normal(size=(n, 13)).astype(np.float32)
    src = np.zeros(d * cap, np.int32)
    valid = np.zeros(d * cap, bool)
    for b in range(d):
        k = int(rng.integers(0, cap + 1))
        src[b * cap:b * cap + k] = np.sort(rng.choice(n, k, replace=False))
        src[b * cap + k:(b + 1) * cap] = rng.integers(0, n, cap - k)
        valid[b * cap:b * cap + k] = True
    g = rng.normal(size=(d * cap, 13)).astype(np.float32)

    want, vjp = jax.vjp(lambda p: jax_gather_rows(p, jnp.asarray(src),
                                                  jnp.asarray(valid)),
                        jnp.asarray(packed))
    (want_grad,) = vjp(jnp.asarray(g))

    def port():
        p = torch.from_numpy(packed).requires_grad_(True)
        rows = S._gather_rows(p, torch.from_numpy(src).long(),
                              torch.from_numpy(valid), d)
        return rows, torch.autograd.grad(rows, p, torch.from_numpy(g))[0]

    rows, grad = port()
    np.testing.assert_array_equal(nn(rows).view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    np.testing.assert_allclose(nn(grad), np.asarray(want_grad), rtol=0,
                               atol=1e-6)
    exact = np.zeros_like(packed)
    for slot in np.nonzero(valid)[0]:  # bucket order
        exact[src[slot]] += g[slot]
    np.testing.assert_array_equal(nn(grad), exact)
    assert torch.equal(port()[1], grad)


def test_pad_to_multiple_and_placements():
    """pad_to_multiple as the JAX one (tests/test_sharded.py's cases and
    a later axis); the placements of gaussian_sharding and replicated."""
    for shape, mult, axis in (((10, 3), 8, 0), ((16, 3), 8, 0),
                              ((2, 5, 3), 4, 1)):
        x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
        got, n = pad_to_multiple(torch.from_numpy(x), mult, axis)
        want, n_want = jax_pad(x, mult, axis)
        assert n == n_want == shape[axis]
        np.testing.assert_array_equal(nn(got), np.asarray(want))
    got, n = pad_to_multiple(np.ones((10, 3)), 8)
    assert isinstance(got, torch.Tensor) and got.shape == (16, 3) and n == 10
    assert (got[10:] == 0).all()
    assert DATA_AXIS == "data"
    assert gaussian_sharding(None) == (Shard(0),)
    assert replicated(None) == (Replicate(),)


def test_one_rank_matches_render_bit_for_bit():
    """D=1 under gloo in this process: the identity route and one-rank
    collectives give render's image, transmittance and gradients bit for
    bit, from plain tensors and from DTensors; a second
    initialize_multihost is a no-op; a mesh larger than the group is
    refused."""
    assert initialize_multihost(f"localhost:{free_port()}", 1, 0,
                                backend="gloo") == 0
    try:
        assert initialize_multihost() == 0
        with pytest.raises(ValueError):
            make_mesh(2)
        mesh = make_mesh()
        x = [torch.from_numpy(a).requires_grad_(True) for a in SCENE]
        res = render_sharded(*x[:4], CAM, mesh, sh=x[4], sh_deg=3,
                             background=BG)
        loss = torch.sum((res.image - torch.from_numpy(TARGET)) ** 2)
        grads = torch.autograd.grad(loss, x)
        single, want = _port_render(SCENE, TARGET, sh_deg=3)
        assert not bool(res.overflow)
        assert torch.equal(res.image, single.image)
        assert torch.equal(res.transmittance, single.transmittance)
        for a, b in zip(grads, want):
            assert torch.equal(a, b)
        # DTensors sharded by gaussian_sharding: their local shards render,
        # and the gradients come back as DTensors of the same placement.
        xd = [distribute_tensor(torch.from_numpy(a), mesh,
                                gaussian_sharding(mesh)).requires_grad_(True)
              for a in SCENE]
        res_d = render_sharded(*xd[:4], CAM, mesh, sh=xd[4], sh_deg=3,
                               background=BG)
        assert torch.equal(res_d.image, single.image)
        loss = torch.sum((res_d.image - torch.from_numpy(TARGET)) ** 2)
        for a, b in zip(torch.autograd.grad(loss, xd), want):
            assert a.placements == (Shard(0),)
            assert torch.equal(a.to_local(), b)
    finally:
        torch.distributed.destroy_process_group()


def test_two_ranks_all_to_all(reference):
    """D=2 (3 tile rows over 2 strips), all_to_all: parity, the strips'
    routed splats and fragments, and two bit-identical backward passes."""
    out = spawn_ranks(render_step, 2,
                      (SCENE, CAM, [dict(sh_deg=3, background=BG)], TARGET,
                       True), backend="gloo", device="cpu",
                      timeout=SPAWN_TIMEOUT)
    items = _check_ranks(out, reference)
    assert all(it["identical"] for it in items)
    stats = [it["stats"] for it in items]
    assert all(s["route_cap"] == 32 for s in stats)  # min(128, n_local)
    assert sum(s["routed"] for s in stats) >= len(SCENE[0]) - 8
    assert all(s["fragments"] > 0 for s in stats)


@pytest.fixture(scope="module")
def four_ranks():
    """One spawn of four ranks: both exchanges with gradients, then the
    knob cases of tests/test_sharded.py (sh_deg 2)."""
    cases = [dict(sh_deg=3, background=BG),
             dict(sh_deg=3, background=BG, exchange="all_gather",
                  per_device_fragments=PER_DEVICE_FRAGMENTS)]
    cases += [dict(sh_deg=2, background=BG, **kw) for kw in KNOB_CASES]
    return spawn_ranks(render_step, 4, (SCENE, CAM, cases, TARGET),
                       backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)


def test_four_ranks_all_to_all(four_ranks, reference):
    """D=4 (3 tile rows: the last strip empty), all_to_all."""
    items = _check_ranks(four_ranks, reference, case=0)
    assert all(s["route_cap"] == 16 for s in (it["stats"] for it in items))


def test_four_ranks_all_gather(four_ranks, reference):
    """D=4, all_gather (every rank bins all N splats), with a strip
    capacity given by per_device_fragments."""
    items = _check_ranks(four_ranks, reference, case=1)
    for it in items:
        assert it["stats"]["routed"] == 64  # all N
        assert it["stats"]["f_cap"] == PER_DEVICE_FRAGMENTS


def test_four_ranks_transform_knobs(four_ranks):
    """size / max_std_dev / no_sh0 / model_transform / antialiased in one
    case, ELLIPSE, POINT: the sharded image within 1e-5 of render's."""
    for k, kw in enumerate(KNOB_CASES, start=2):
        single, _ = _port_render(SCENE, sh_deg=2, **kw)
        for o in four_ranks:
            assert not o[k]["overflow"], kw
            np.testing.assert_allclose(nn(o[k]["image"]), nn(single.image),
                                       rtol=0, atol=SHARDED_ATOL,
                                       err_msg=str(kw))


MULTIHOST_WORKER = textwrap.dedent("""
    import json
    import sys
    import torch
    import torch.distributed as dist
    from wgpu_3dgs_core_tpu_torch.parallel import (
        initialize_multihost, make_mesh)
    addr, world, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    assert initialize_multihost(addr, world, pid, backend="gloo") == pid
    assert dist.get_world_size() == world
    assert initialize_multihost() == pid  # a second call is a no-op
    mesh = make_mesh()
    assert mesh.size() == world and mesh.get_local_rank(0) == pid
    x = torch.tensor([float(pid + 1)])
    dist.all_reduce(x, group=mesh.get_group(0))
    assert float(x) == world * (world + 1) / 2
    # make_mesh(n_devices, devices): the ranks the JAX make_mesh puts in
    # its mesh for the same arguments; a rank outside the group raises.
    for n, devices, want in json.loads(sys.argv[4]):
        sub = make_mesh(n, devices=devices)
        assert sub.mesh.tolist() == want, (n, devices, sub.mesh.tolist())
        where = (want.index(pid),) if pid in want else None
        assert sub.get_coordinate() == where, (n, devices, where)
    for bad in ([world], [-1], [0, 0]):
        try:
            make_mesh(devices=bad)
        except ValueError:
            continue
        raise AssertionError(f"make_mesh(devices={bad}) did not raise")
    dist.destroy_process_group()
    print(f"proc {pid}: multihost OK", flush=True)
""")


def test_initialize_multihost_two_processes():
    """Two processes through initialize_multihost over tcp://, as
    tests/_multihost_worker.py checks the JAX one: each gets its rank, a
    second call is a no-op, the mesh spans both and its group reduces;
    make_mesh over named ranks holds the ranks the JAX make_mesh takes of
    the same device indices, and refuses ranks outside the group."""
    jax_devices = jax.devices()
    cases = [[n, devices, [int(d.id) for d in jax_make_mesh(
                 n, devices=[jax_devices[i] for i in devices]).devices]]
             for n, devices in ((None, [1, 0]), (1, [1, 0]), (None, [0, 1]),
                                (1, [0, 1]), (2, [1, 0]))]
    addr = f"localhost:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_WORKER, addr, "2", str(i),
         json.dumps(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out}"
        assert f"proc {i}: multihost OK" in out


def test_entry_forward():
    """entry() on the CPU: the JAX entry's scene (sigma6 within 1e-6, the
    rest bit for bit) and a finite 256x256 image."""
    from __graft_entry__ import _synthetic_scene as jax_scene

    fn, args = E.entry(device="cpu")
    for a, b in zip(args, jax_scene(E.ENTRY_GAUSSIANS)):
        np.testing.assert_allclose(nn(a), np.asarray(b), rtol=0, atol=1e-6)
    img = fn(*args)
    assert img.shape == (256, 256, 3) and torch.isfinite(img).all()
    assert float(img.max()) > 0


def test_dryrun_multichip_and_failures_on_cpu():
    """dryrun_multichip(2) on the CPU: the loss equals the single-device
    render's on the same scene; a rank that raises fails the spawn with
    its traceback; NCCL is refused for ranks without a card each."""
    loss = E.dryrun_multichip(2, device="cpu")
    scene = [torch.from_numpy(a) for a in E._synthetic_scene(512)]
    res = T.render(*scene[:4], E._camera(128), sh=scene[4], sh_deg=3,
                   max_fragments=16384)
    assert np.isfinite(loss)
    assert abs(loss - float(torch.mean(res.image ** 2))) <= 1e-6
    with pytest.raises(RuntimeError, match="unknown exchange mode"):
        spawn_ranks(render_step, 2, (SCENE, CAM, [dict(exchange="ring")]),
                    backend="gloo", device="cpu", timeout=SPAWN_TIMEOUT)
    with pytest.raises(ValueError, match="NCCL"):
        spawn_ranks(render_step, 2, (), backend="nccl", device="cpu")
