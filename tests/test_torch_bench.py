"""The port bench (``wgpu_3dgs_core_tpu_torch.bench``) against bench.py.

Its scenes against ``bench.synthetic_scene`` and ``heavy_scene`` (the same
numpy draws bit for bit, cov6 within 1e-6); its step at a tiny size on
the CPU (2,000 gaussians, 160x96) against ``jax.value_and_grad`` of the
JAX ``render`` loss (JAX Pallas kernels in interpret mode): the loss
within 1e-5 relative, the gradients within 1e-4 normalized; K9's full
level (K3 itself) on that step's stream bit for bit against the port's
plain K3 and, composited into the image, within 3e-5 of the JAX forward;
the first designs of K3 and K5 (their plain versions on the CPU) equal
to K3's and K5's; and its command line, which prints bench.py's JSON
keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from wgpu_3dgs_core_tpu import Camera as JCamera
from wgpu_3dgs_core_tpu import render as jrender
from wgpu_3dgs_core_tpu_torch import bench as pb
from wgpu_3dgs_core_tpu_torch.ops.rasterize import (
    rasterize_tiles_fwd_plain,
    tiles_to_image,
)
from wgpu_3dgs_core_tpu_torch.render.renderer import measure_capacities
from wgpu_3dgs_core_tpu_torch.ops.segreduce import segment_sums_sorted_plain
from wgpu_3dgs_core_tpu_torch.ops.variants import (
    rasterize_fwd_first,
    rasterize_level,
    segment_sums_first,
)
from wgpu_3dgs_core_tpu_torch.tools.bench_kernel_variants import bench_stream
from wgpu_3dgs_core_tpu_torch.tools.bench_segsum import hard_streams

from .torch_parity import IMAGE_ATOL, nn, one_torch_thread  # noqa: F401

N, W, H = 2000, 160, 96
PAD_SLACK, SH_DEG = 0.65, 3
GRAD_TOL = 1e-4  # normalized, tests/test_render.py
LOSS_RTOL = 1e-5
KEYS = {"metric", "value", "unit", "vs_baseline", "msplats_s", "step_ms",
        "loss", "overflow"}
FULL_KEYS = KEYS | {"fwd_ms", "bwd_ms", "heavy_mpix_s", "heavy_step_ms",
                    "heavy_overflow"}


@pytest.mark.parametrize("make,ref", [
    (pb.synthetic_scene, bench.synthetic_scene),
    (pb.heavy_scene, bench.heavy_scene),
])
def test_scenes_equal_bench_py(make, ref):
    mine = make(1000, device="cpu")
    want = [np.asarray(a) for a in ref(1000)]
    for i, (a, b) in enumerate(zip(mine, want)):
        if i == 1:  # cov6: the port's cov3d_from_rot_scale against JAX's
            np.testing.assert_allclose(nn(a), b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(nn(a), b)


@pytest.fixture(scope="module")
def step_pair():
    """The bench step on the tiny scene: the port's (loss, overflow, grads)
    and JAX's (loss, overflow, image, grads), at the capacities the port
    measures for it."""
    scene = pb.synthetic_scene(N, device="cpu")
    cam = pb.bench_camera(W, H)
    max_fragments, max_rows = measure_capacities(scene[0], scene[1],
                                                 scene[3], cam)
    step, _ = pb.make_step(cam, max_fragments, max_rows, PAD_SLACK, SH_DEG)
    mine = step(pb.leaves(scene))

    jcam = JCamera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                           width=W, height=H, fov_y=0.9)

    def loss_fn(means, cov6, color, opac, sh):
        res = jrender(means, cov6, color, opac, jcam, sh=sh, sh_deg=SH_DEG,
                      background=(0.0, 0.0, 0.0),
                      max_fragments=max_fragments, pad_slack=PAD_SLACK,
                      max_rows=max_rows)
        return jnp.mean(res.image ** 2), (res.overflow, res.image)

    (loss, (overflow, image)), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *bench.synthetic_scene(N))
    return scene, cam, (max_fragments, max_rows), mine, (
        float(loss), bool(overflow), np.asarray(image),
        [np.asarray(g) for g in grads])


def test_bench_step_matches_jax(step_pair):
    _, _, _, (loss, overflow, grads), (jloss, joverflow, _, jgrads) = (
        step_pair)
    assert not bool(overflow) and not joverflow
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    for name, a, b in zip(("means", "cov6", "color", "opacity", "sh"), grads,
                          jgrads):
        err = np.abs(nn(a) - b).max() / (np.abs(b).max() + 1e-12)
        assert err <= GRAD_TOL, f"{name}: normalized error {err:.3g}"


def _bench_k3_args(step_pair):
    scene, cam, caps, *_ = step_pair
    with torch.no_grad():
        return bench_stream(scene, cam, *caps, pad_slack=PAD_SLACK,
                            sh_deg=SH_DEG)


def test_k9_v6_full_on_the_bench_stream(step_pair):
    """K9's full level (its plain version on the CPU) is the port's plain
    K3 bit for bit, and its tiles, composited as render does, are within
    3e-5 of the JAX render's image (its Pallas forward kernel)."""
    jimage = step_pair[4][2]
    frags, start, draw_len, bg = _bench_k3_args(step_pair)
    tiles = rasterize_level("v6_full", frags, start, draw_len, bg)
    want = rasterize_tiles_fwd_plain(frags, start, draw_len, bg)
    assert torch.equal(tiles.view(torch.int32), want.view(torch.int32))
    written = (draw_len > 0)[:, None, None]
    tiles = torch.where(written, tiles,
                        torch.tensor([*bg, 1.0])[None, :, None])
    tx, ty = -(-W // 16), -(-H // 16)
    image = tiles_to_image(tiles, tx, ty, W, H)[..., 0:3]
    np.testing.assert_allclose(nn(image), jimage, atol=IMAGE_ATOL, rtol=0)


def test_first_designs_plain_equal_k3_and_k5_plain(step_pair):
    """K3's first design on the bench step's stream and K5's on the
    streams K5 finds hard, through their plain versions on the CPU: K3's
    and K5's plain versions, bit for bit."""
    k3 = _bench_k3_args(step_pair)
    assert torch.equal(rasterize_fwd_first(*k3).view(torch.int32),
                       rasterize_tiles_fwd_plain(*k3).view(torch.int32))
    for name, st in hard_streams().items():
        assert torch.equal(segment_sums_first(*st).view(torch.int32),
                           segment_sums_sorted_plain(*st).view(torch.int32)
                           ), name


def test_small_takes_bench_py_settings():
    args = pb.parse(["--small"])
    assert (args.gaussians, args.width, args.height) == (10_000, 512, 512)
    assert (args.max_fragments, args.heavy_max_fragments, args.max_rows,
            args.heavy_max_rows) == (262_144, 1_048_576, 131_072, 262_144)
    assert (args.iters, args.warmup) == (3, 1)
    full = pb.parse([])
    assert (full.max_fragments, full.max_rows, full.heavy_max_fragments,
            full.heavy_max_rows, full.pad_slack, full.sh_deg) == (
        2_957_312, 1_887_232, 7_311_360, 2_894_848, 0.65, 3)


def test_main_prints_one_json_line(capsys):
    tiny = ["--device", "cpu", "--gaussians", "500", "--width", "64",
            "--height", "48", "--max-fragments", "2048", "--max-rows",
            "2048", "--heavy-max-fragments", "8192", "--heavy-max-rows",
            "4096", "--iters", "1", "--warmup", "1"]
    for extra, keys in (([], KEYS), (["--full"], FULL_KEYS)):
        pb.main(tiny + extra)
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1
        line = json.loads(lines[0])
        assert set(line) == keys
        assert line["unit"] == "Mpix/s" and "cpu" in line["metric"]
        assert not line["overflow"] and not line.get("heavy_overflow")
        assert np.isfinite(line["loss"]) and line["step_ms"] > 0
