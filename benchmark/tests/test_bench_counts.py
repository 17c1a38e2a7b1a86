"""The frozen work counts and the tiled reference against a brute-force
blend of every gaussian at every pixel."""

import pytest
import torch

from benchmark import scene as sc
from benchmark.reference import render as rr
from benchmark.reference import train as rt


def brute(cols, depth, valid, width, height):
    """Image, transmittance and counts by the blend rules, pixel by
    pixel over every gaussian, in float64."""
    c = cols.double()
    order = torch.sort(torch.where(valid, depth.double(),
                                   torch.full_like(depth.double(), 1e30)),
                       stable=True).indices
    c = c[order]
    ys, xs = torch.meshgrid(torch.arange(height), torch.arange(width),
                            indexing="ij")
    px = xs.reshape(-1).double() + 0.5
    py = ys.reshape(-1).double() + 0.5
    dx = px[None] - c[:, 0:1]
    dy = py[None] - c[:, 1:2]
    q = c[:, 2:3] * dx * dx + 2 * c[:, 3:4] * dx * dy + c[:, 4:5] * dy * dy
    alpha = torch.clamp(c[:, 8:9] * torch.exp(-0.5 * q), max=0.99)
    kept = (q <= 9.0) & (alpha >= 1 / 255)
    alpha = torch.where(kept, alpha, 0.0)
    t = torch.cumprod(1 - alpha, 0)
    t_before = torch.cat([torch.ones_like(t[:1]), t[:-1]])
    blended = kept & (t_before > 1e-4)
    w = torch.where(blended, alpha * t_before, 0.0)
    img = (w.T @ c[:, 5:8]).reshape(height, width, 3)
    trans = torch.prod(torch.where(blended, 1 - alpha, 1.0), 0)
    tile = ((ys // 16) * (-(-width // 16)) + xs // 16).reshape(-1)
    frag = set()
    for g, p in torch.nonzero(kept).tolist():
        frag.add((g, int(tile[p])))
    counts = rr.Counts(gaussians=cols.shape[0], visible=int(valid.sum()),
                       used=int(kept.any(1).sum()), fragments=len(frag),
                       blended=int(blended.sum()), pixels=width * height)
    return img.float(), trans.reshape(height, width).float(), counts


@pytest.mark.parametrize("seed,scale", [(3, 1.0), (4, 6.0)])
def test_tiled_reference_equals_brute_force(seed, scale):
    cfg = {"gaussians": 1500, "width": 72, "height": 40, "scene": {
        "half_extent": [3.0, 1.8, 2.0], "scale_lo": 0.004 * scale,
        "scale_hi": 0.012 * scale, "opacity_lo": 0.2, "opacity_hi": 0.9,
        "sh_std": 0.1}}
    traffic = {"radius": 6.0, "fov_y": 0.9, "near": 0.01, "far": 1000.0}
    scene = sc.draw_scene(cfg, seed, "cpu")
    view = sc.orbit_view(cfg, traffic, 7.0, -3.0)
    inputs = rt.constrained(rt.initial_params(scene))
    cols, depth, valid = rr.splat_columns(*inputs, view)
    # Small groups, so that several groups and tile lengths are exercised.
    img, trans, counts = rr.render(cols, depth, valid, 72, 40, counts=True,
                                   group_elems=1 << 14)
    b_img, b_trans, b_counts = brute(cols, depth, valid, 72, 40)
    assert counts == b_counts
    assert counts.blended > 1000 and counts.fragments > counts.used
    assert torch.allclose(img, b_img, atol=2e-6)
    assert torch.allclose(trans, b_trans, atol=2e-6)


def test_loss_gradient_equals_autograd_of_the_image():
    cfg = {"gaussians": 400, "width": 40, "height": 24, "scene": {
        "half_extent": [3.0, 1.8, 2.0], "scale_lo": 0.02, "scale_hi": 0.05,
        "opacity_lo": 0.2, "opacity_hi": 0.9, "sh_std": 0.1}}
    traffic = {"radius": 6.0, "fov_y": 0.9, "near": 0.01, "far": 1000.0}
    scene = sc.draw_scene(cfg, 5, "cpu")
    view = sc.orbit_view(cfg, traffic, 0.0, 0.0)
    cols, depth, valid = rr.splat_columns(
        *rt.constrained(rt.initial_params(scene)), view)
    target = torch.rand(24, 40, 3, generator=torch.Generator().manual_seed(1))
    loss, grad = rr.loss_and_grad(cols, depth, valid, 40, 24, target,
                                  group_elems=1 << 12)
    leaf = cols.detach().double().requires_grad_(True)
    b_img, _, _ = brute(leaf, depth, valid, 40, 24)
    # brute() rounds its image to float32; redo its blend differentiably.
    img = brute_image_double(leaf, depth, valid, 40, 24)
    ref = torch.mean((img - target.double()) ** 2)
    ref.backward()
    assert float(loss) == pytest.approx(float(ref.detach()), rel=1e-5)
    assert torch.allclose(grad.double(), leaf.grad, rtol=1e-3, atol=1e-7)
    assert torch.allclose(b_img.double(), img.detach(), atol=1e-6)


def brute_image_double(c, depth, valid, width, height):
    order = torch.sort(torch.where(valid, depth.double(),
                                   torch.full_like(depth.double(), 1e30)),
                       stable=True).indices
    c = c[order]
    ys, xs = torch.meshgrid(torch.arange(height), torch.arange(width),
                            indexing="ij")
    px = xs.reshape(-1).double() + 0.5
    py = ys.reshape(-1).double() + 0.5
    dx = px[None] - c[:, 0:1]
    dy = py[None] - c[:, 1:2]
    q = c[:, 2:3] * dx * dx + 2 * c[:, 3:4] * dx * dy + c[:, 4:5] * dy * dy
    raw = c[:, 8:9] * torch.exp(-0.5 * q)
    alpha = torch.where(raw < 0.99, raw, torch.full_like(raw, 0.99))
    kept = (q <= 9.0) & (alpha >= 1 / 255)
    alpha = torch.where(kept, alpha, torch.zeros_like(alpha))
    t = torch.cumprod(1 - alpha, 0)
    t_before = torch.cat([torch.ones_like(t[:1]), t[:-1]])
    w = torch.where(kept & (t_before > 1e-4), alpha * t_before,
                    torch.zeros_like(alpha))
    return (w.T @ c[:, 5:8]).reshape(height, width, 3)
