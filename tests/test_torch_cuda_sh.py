"""The SH colour kernels (``csrc/sh.cu``, ``ops/sh.py::sh_color``) on the
card (marker ``cuda``): forward and backward against the plain forward and
``sh_color_bwd_plain`` at N = 100,003 (not a multiple of the block) and
sh_deg 1-3, through strided inputs as the renderer passes them (a [N, 4]
colour's first columns, a column-major d_rgb) and through a misaligned SH
tensor; two runs bit-identical; one launch and one ``sh_color`` count in
each direction; a second derivative refused; and ``render`` plus
``backward`` against the CPU.

These need a CUDA card and nvcc, and skip without one. On a machine with
a card: ``python -m pytest -m cuda tests/test_torch_cuda_sh.py``, with
``--noconftest`` where jax is not installed.
"""

import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu_torch.ops import sh as S
from wgpu_3dgs_core_tpu_torch.utils.profiling import counting

pytestmark = pytest.mark.cuda

N = 100_003
# A camera centre near the origin, so that gaussians can lie within the
# 1e-12 norm clamp's reach of it in float32.
CAM_POS = (2e-13, -1e-13, 0.0)
# Gradients against the closed form: the ROADMAP's bar, normalized per
# gaussian by its largest entry (the kernel contracts into FMAs and sums
# in its own order; the plain version runs torch's elementwise ops).
GRAD_TOL = 1e-4
W, H = 96, 64


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(device, n=N, seed=0):
    """(colour [n, 4], whose first three columns are the base colour, sh,
    means, d_rgb column-major), with colours at the clamp and gaussians
    within the norm clamp's reach of the camera centre."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    means[:2] = np.array([[3e-13, 1e-13, -2e-13], [0.0, -4e-13, 1e-13]],
                         np.float32)
    color = rng.random((n, 4)).astype(np.float32)
    sh = (0.3 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    color[2:5, :3], sh[2:5] = 0.0, 0.0  # colours exactly at the clamp
    color[5:500, :3] *= 0.05  # clamped colours
    d_rgb = rng.normal(size=(3, n)).astype(np.float32)
    t = [torch.from_numpy(x).to(device) for x in (color, sh, means, d_rgb)]
    return t[0], t[1], t[2], t[3].T


def _row_err(a, b) -> float:
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    den = b.abs().amax(dim=1, keepdim=True)
    return float(((a - b).abs() / torch.where(den > 0, den, 1.0)).max())


def _kernel_grads(color, sh, means, d_rgb, sh_deg, no_sh0):
    """rgb and the gradients (d_base or None, d_sh, d_means) through the
    kernels, the base colour read strided from ``color``."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (color, sh, means)]
    rgb = S.sh_color(leaves[0][:, :3], *leaves[1:], CAM_POS, sh_deg, no_sh0)
    rgb.backward(d_rgb)
    d_color = leaves[0].grad
    return rgb.detach(), [None if d_color is None else d_color[:, :3],
                          leaves[1].grad, leaves[2].grad]


@pytest.mark.parametrize("no_sh0", [False, True])
@pytest.mark.parametrize("sh_deg", [1, 2, 3])
def test_kernels_match_plain(cuda, sh_deg, no_sh0):
    """The forward equals the plain forward bit for bit (each operation
    rounded once, in torch's order); the backward is within GRAD_TOL of
    the closed form, whose d_sh rows above sh_deg are exact zeros."""
    color, sh, means, d_rgb = _inputs(cuda)
    base = color[:, :3]
    assert not base.is_contiguous() and not d_rgb.is_contiguous()
    rgb, (d_base, d_sh, d_means) = _kernel_grads(color, sh, means, d_rgb,
                                                  sh_deg, no_sh0)
    want = S.sh_color_plain(base, sh, means, CAM_POS, sh_deg, no_sh0)
    assert torch.equal(rgb, want)
    p_base, p_sh, p_means = S.sh_color_bwd_plain(
        base, sh, means, CAM_POS, sh_deg, no_sh0, d_rgb)
    if no_sh0:
        assert d_base is None
    else:
        assert _row_err(d_base, p_base) == 0.0
    assert _row_err(d_sh, p_sh) <= GRAD_TOL
    assert _row_err(d_means, p_means) <= GRAD_TOL
    assert not d_sh[:, (sh_deg + 1) ** 2 - 1:].any()
    assert bool(torch.isfinite(d_means).all())


def test_misaligned_sh_and_two_runs_bit_identical(cuda):
    """An SH tensor whose rows start off 16-byte alignment takes the
    scalar staging path and gives the aligned tensor's results; two runs
    give the same bits."""
    color, sh, means, d_rgb = _inputs(cuda)
    flat = torch.empty(sh.numel() + 1, device=cuda)
    shifted = flat[1:].view(sh.shape)
    shifted.copy_(sh)
    assert shifted.data_ptr() % 16 != 0
    first = _kernel_grads(color, sh, means, d_rgb, 3, False)
    second = _kernel_grads(color, sh, means, d_rgb, 3, False)
    third = _kernel_grads(color, shifted, means, d_rgb, 3, False)
    for other in (second, third):
        assert torch.equal(first[0].view(torch.int32),
                           other[0].view(torch.int32))
        for a, b in zip(first[1], other[1]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_launch_counts(cuda):
    """One launch of each kernel and one ``sh_color`` count a forward and
    backward; none without a backward under no_grad."""
    color, sh, means, d_rgb = _inputs(cuda, n=1000)
    T.reset_launch_counts()
    with counting() as counts:
        _kernel_grads(color, sh, means, d_rgb, 3, False)
        torch.cuda.synchronize()
    launches = T.launch_counts()
    assert launches["sh_color_fwd"] == 1 and launches["sh_color_bwd"] == 1
    assert counts.totals() == ({"sh_color": 1}, {"sh_color": 1})
    with torch.no_grad():
        S.sh_color(color[:, :3], sh, means, CAM_POS, 3)
    launches = T.launch_counts()
    assert launches["sh_color_fwd"] == 2 and launches["sh_color_bwd"] == 1


def test_second_derivative_raises(cuda):
    """The backward kernel builds no graph: a gradient taken with
    create_graph=True cannot be differentiated again, and says so."""
    color, sh, means, _ = _inputs(cuda, n=1000)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (color[:, :3], sh, means)]
    rgb = S.sh_color(*leaves, CAM_POS, 3)
    (g_means,) = torch.autograd.grad((rgb * rgb).sum(), leaves[2],
                                     create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g_means.sum().backward()


def test_render_backward_matches_cpu(cuda):
    """render at sh_deg 3 and its backward on the card against the CPU
    path (the plain graph): image within 3e-5, gradients within 1e-4
    normalized; both SH kernels launched once."""
    rng = np.random.default_rng(5)
    n = 2000
    means = np.empty((n, 3), np.float32)
    means[:, 0] = rng.uniform(-1.5, 1.5, n)
    means[:, 1] = rng.uniform(-1.0, 1.0, n)
    means[:, 2] = rng.uniform(-1.0, 1.0, n)
    cov6 = np.tile(np.array([0.003, 0, 0, 0.003, 0, 0.003], np.float32),
                   (n, 1))
    color = rng.random((n, 3)).astype(np.float32)
    opac = (0.2 + 0.7 * rng.random(n)).astype(np.float32)
    sh = (0.2 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    target = rng.random((H, W, 3)).astype(np.float32)
    cam = T.Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                           width=W, height=H, fov_y=0.9)

    def step(device):
        x = [torch.from_numpy(a).to(device).requires_grad_(True)
             for a in (means, cov6, color, opac, sh)]
        res = T.render(*x[:4], cam, sh=x[4], sh_deg=3, background=(0.1,) * 3)
        assert not bool(res.overflow)
        loss = ((res.image - torch.from_numpy(target).to(device)) ** 2).sum()
        return res.image.detach(), torch.autograd.grad(loss, x)

    T.reset_launch_counts()
    img, grads = step(cuda)
    launches = T.launch_counts()
    assert launches["sh_color_fwd"] == 1 and launches["sh_color_bwd"] == 1
    ref_img, ref_grads = step("cpu")
    assert float((img.cpu() - ref_img).abs().max()) <= 3e-5
    for a, b in zip(grads, ref_grads):
        err = float((a.cpu() - b).abs().max() / b.abs().max())
        assert err <= 1e-4, err
