"""The torch port's CUDA kernels on the card (marker ``cuda``): the
forward kernels K1-K3 and the backward kernels K4-K6 against their plain
versions, launch counts, and the determinism of the backward.

These need a CUDA card and nvcc, and skip without one. On a machine with
a card: ``python -m pytest -m cuda tests/test_torch_cuda.py``, with
``--noconftest`` where jax is not installed (tests/conftest.py imports
it). The same checks run at full size in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu_torch.ops import expand as TE
from wgpu_3dgs_core_tpu_torch.ops import rasterize as TR
from wgpu_3dgs_core_tpu_torch.ops import segreduce as TS
from wgpu_3dgs_core_tpu_torch.ops.binning import (
    bin_splats_attrs, gaussian_table, num_tiles, pad_schedule, row_table,
)
from wgpu_3dgs_core_tpu_torch.ops.projection import project
from wgpu_3dgs_core_tpu_torch.ops.transforms import cov3d_from_rot_scale
from wgpu_3dgs_core_tpu_torch.render.renderer import tile_local_stream

pytestmark = pytest.mark.cuda

W, H = 256, 192
CAM = T.Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                       width=W, height=H, fov_y=0.9)
BG = (0.1, 0.2, 0.3)
FORWARD_KERNELS = ("expand_rows", "expand_fragments", "rasterize_fwd")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scene(device, n=2500, seed=3):
    """tests/test_rowtrim.py's scene as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    means = np.empty((n, 3), np.float32)
    means[:, 0] = rng.uniform(-1.5, 1.5, n)
    means[:, 1] = rng.uniform(-1.0, 1.0, n)
    means[:, 2] = rng.uniform(-1.0, 1.0, n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = rng.uniform(0.01, 0.08, (n, 3)).astype(np.float32)
    color = rng.random((n, 3)).astype(np.float32)
    opac = (0.2 + 0.7 * rng.random(n)).astype(np.float32)
    t = [torch.from_numpy(x).to(device)
         for x in (means, q, scales, color, opac)]
    return t[0], cov3d_from_rot_scale(t[1], t[2]), t[3], t[4]


def _binned(device):
    means, cov6, color, opac = _scene(device)
    spl = project(means, cov6, CAM, opacity=opac)
    attr = torch.cat([spl.xy.T, spl.conic.T, color.T,
                      (opac * spl.mask)[None]], dim=0)
    tx, ty = num_tiles(W, H)
    return spl, attr, tx, ty


def test_expand_kernels_equal_plain_bit_for_bit(cuda):
    spl, attr, tx, ty = _binned(cuda)
    table, total_rows = gaussian_table(spl.xy, spl.extent, spl.depth,
                                       spl.mask, attr, tx, ty)
    rows = TE.expand_rows(table, total_rows, 8192)
    plain = TE.expand_rows_plain(table, total_rows, 8192)
    assert torch.equal(rows.ints, plain.ints)
    assert torch.equal(rows.attrs.view(torch.int32),
                       plain.attrs.view(torch.int32))
    rtab, total = row_table(rows, total_rows)
    got = TE.expand_fragments_with_attrs(rtab, total, 8192, tx, tx * ty)
    want = TE.expand_fragments_with_attrs_plain(rtab, total, 8192, tx,
                                                tx * ty)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
    assert 0 < int(total) < 8192


@pytest.mark.parametrize("mode", [0, 1])
def test_rasterize_kernel_matches_plain(cuda, mode):
    spl, attr, tx, ty = _binned(cuda)
    stream, attrs_sorted, _ = bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr, tx, ty, 8192,
        opacity_cull=mode != 1,
    )
    sched = pad_schedule(stream, 8192 + tx * ty * 128)
    frags = tile_local_stream(attrs_sorted, stream.tile_id, tx)
    args = (frags, stream.tile_start, sched.draw_len, BG, 9.0, mode)
    got = TR.rasterize_tiles_fwd(*args)
    want = TR.rasterize_tiles_fwd_plain(*args)
    assert float((got - want).abs().max()) <= 3e-5


def _backward_inputs(cuda, mode):
    """K4's, K5's and K6's inputs on the scene's stream, with a random
    cotangent of K3's output."""
    spl, attr, tx, ty = _binned(cuda)
    stream, attrs_sorted, table = bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr, tx, ty, 8192,
        opacity_cull=mode != 1,
    )
    sched = pad_schedule(stream, 8192 + tx * ty * 128)
    frags = tile_local_stream(attrs_sorted, stream.tile_id, tx)
    out = TR.rasterize_tiles_fwd(frags, stream.tile_start, sched.draw_len,
                                 BG, 9.0, mode)
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    k4 = (frags, stream.tile_start, stream.tile_end - stream.tile_start,
          sched.draw_len, out, g, BG, 9.0, mode)
    n = table.ints.shape[1]
    keys, perm = TS.sort_keys(stream.gauss_id, stream.tile_id,
                              stream.tile_start, sched.draw_len, n)
    return k4, (keys, perm, TS.gid_column_sorted(table.ints, n), n)


def _normalized(got, want):
    scale = want.abs().amax(dim=1)
    err = (got - want).abs().amax(dim=1)
    return float(torch.where(scale > 0, err / scale, err).max())


@pytest.mark.parametrize("mode", [0, 1])
def test_backward_kernels_match_plain(cuda, mode):
    """K4 within 1e-4 of each gradient row's largest value, K5 within
    1e-5 of each row's largest sum (its plain version sums in f64), K6 bit
    for bit; slots K4 did not draw are exact zeros."""
    k4, (keys, perm, gid_col, n) = _backward_inputs(cuda, mode)
    dfrag = TR.rasterize_tiles_bwd(*k4)
    plain = TR.rasterize_tiles_bwd_plain(*k4)
    assert bool(torch.isfinite(dfrag).all())
    assert _normalized(dfrag, plain) <= 1e-4
    undrawn = perm[keys >= n]  # sort_keys keys the undrawn slots past n
    assert undrawn.numel() > 0 and not bool(dfrag[:, undrawn].any())
    comp = TS.segment_sums_sorted(keys, perm, dfrag, gid_col, n)
    want = TS.segment_sums_sorted_plain(keys, perm, dfrag, gid_col, n)
    assert _normalized(comp, want) <= 1e-5
    got = TS.uncompact_columns(comp, gid_col, n)
    assert torch.equal(got.view(torch.int32),
                       TS.uncompact_columns_plain(comp, gid_col, n)
                       .view(torch.int32))


def test_backward_is_deterministic(cuda):
    """Two backward passes of render give bit-identical gradients, which
    match the CPU's within the gradient bar."""
    args = _scene(cuda)
    target = torch.rand((H, W, 3), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))

    def grads(args):
        x = [a.detach().clone().requires_grad_(True) for a in args]
        res = T.render(*x, CAM, background=BG)
        assert not bool(res.overflow)
        loss = ((res.image - target.to(x[0].device)) ** 2).sum()
        return torch.autograd.grad(loss, x)

    T.reset_launch_counts()
    first = grads(args)
    counts = T.launch_counts()
    assert all(v == 1 for v in counts.values()), counts
    second = grads(args)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    on_cpu = grads([a.cpu() for a in args])
    for a, b in zip(first, on_cpu):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-4


def test_render_on_card_matches_cpu_and_counts_launches(cuda):
    args = _scene(cuda)
    T.reset_launch_counts()
    res = T.render(*args, CAM, background=BG)
    torch.cuda.synchronize()
    assert T.launch_counts() == {"expand_rows": 1, "expand_fragments": 1,
                                 "rasterize_fwd": 1, "rasterize_bwd": 0,
                                 "segment_sums": 0, "uncompact": 0}
    ref = T.render(*(a.cpu() for a in args), CAM, background=BG)
    assert not bool(res.overflow) and not bool(ref.overflow)
    err = float((res.image.cpu() - ref.image).abs().max())
    assert err <= 3e-5, err


def test_empty_and_culled_scenes_on_card(cuda):
    """No gaussians, and only gaussians behind the camera: the kernels run
    over their whole capacity with nothing live and the image is the
    background."""
    empty = [torch.zeros(shape, device=cuda)
             for shape in ((0, 3), (0, 6), (0, 3), (0,))]
    culled = [torch.tensor([[0.0, 0.0, -10.0]] * 5, device=cuda),
              torch.tensor([[0.01, 0.0, 0.0, 0.01, 0.0, 0.01]] * 5,
                           device=cuda),
              torch.ones((5, 3), device=cuda), torch.ones(5, device=cuda)]
    for args in (empty, culled):
        T.reset_launch_counts()
        res = T.render(*args, CAM, background=BG)
        torch.cuda.synchronize()
        counts = T.launch_counts()
        assert all(counts[k] == 1 for k in FORWARD_KERNELS), counts
        assert not bool(res.overflow)
        bg = torch.tensor(BG, device=cuda)
        assert torch.equal(res.image, bg.expand_as(res.image))
        assert bool((res.transmittance == 1.0).all())
