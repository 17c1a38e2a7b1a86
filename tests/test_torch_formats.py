"""The torch port's numpy layers, buffers and plumbing.

The copied format layers equal the JAX package's bit for bit; the port
imports without jax, nvcc or triton; a CPU render launches no kernel.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu_torch import convert
from wgpu_3dgs_core_tpu_torch.ops.cuda import on_cpu

from .torch_parity import EXAMPLE_PLY, nn, one_torch_thread, tt  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def soas():
    return (T.GaussianSoA.from_ply(T.read_ply(EXAMPLE_PLY)),
            J.GaussianSoA.from_ply(J.read_ply(str(EXAMPLE_PLY))))


def _assert_fields_equal(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if y is None:
            assert x is None, f
            continue
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_ply_and_soa_bit_identical(soas):
    mine, ref = soas
    assert len(mine) == len(ref) > 0
    np.testing.assert_array_equal(T.read_ply(EXAMPLE_PLY).block,
                                  J.read_ply(str(EXAMPLE_PLY)).block)
    _assert_fields_equal(mine, ref, ("rot", "pos", "color", "sh", "scale"))
    np.testing.assert_array_equal(mine.to_ply().block, ref.to_ply().block)


@pytest.mark.parametrize("idx", range(12))
def test_pack_all_layouts_bit_identical(soas, idx):
    mine, ref = soas
    lm, lj = T.ALL_LAYOUTS[idx], J.ALL_LAYOUTS[idx]
    assert (lm.sh.value, lm.cov3d.value) == (lj.sh.value, lj.cov3d.value)
    pm, pj = T.pack(mine, lm), J.pack(ref, lj)
    _assert_fields_equal(pm, pj, ("pos", "color", "sh", "cov3d"))
    assert lm.bytes_per_gaussian == lj.bytes_per_gaussian


def test_soa_zeros_and_concatenate():
    z = T.GaussianSoA.zeros(3)
    both = T.GaussianSoA.concatenate([z, z[1:]])
    _assert_fields_equal(both, J.GaussianSoA.concatenate(
        [J.GaussianSoA.zeros(3), J.GaussianSoA.zeros(2)]),
        ("rot", "pos", "color", "sh", "scale"))


def test_buffer_round_trip_and_validation(soas):
    mine, _ = soas
    layout = T.GaussianLayout(sh=T.ShFormat.HALF, cov3d=T.Cov3dFormat.HALF)
    buf = T.GaussiansBuffer.new(mine, layout, device="cpu")
    assert len(buf) == len(mine) and buf.device.type == "cpu"
    assert buf.data.cov3d.dtype == torch.float16
    _assert_fields_equal(buf.download_packed(), T.pack(mine, layout),
                         ("pos", "color", "sh", "cov3d"))
    p = T.pack(mine, layout)
    with pytest.raises(T.GaussiansBufferTryFromBufferError):
        T.GaussiansBuffer.from_arrays(layout, p.pos, p.color, p.sh,
                                      p.cov3d[:, :3], device="cpu")
    again = T.GaussiansBuffer.from_arrays(layout, p.pos, p.color, p.sh,
                                          p.cov3d, device="cpu")
    _assert_fields_equal(again.download_packed(), p,
                         ("pos", "color", "sh", "cov3d"))


@pytest.mark.parametrize("kw", [
    {}, dict(display_mode=1, sh_deg=1, no_sh0=True, max_std_dev=2.1),
    dict(size=0.5, display_mode=2, sh_deg=0, max_std_dev=0.7),
])
def test_gaussian_transform_flags_equal(kw):
    mine = T.GaussianTransform(**kw)
    ref = J.GaussianTransform(**kw)
    assert mine.flags == ref.flags
    assert mine.to_pod() == ref.to_pod()
    assert T.GaussianTransform.from_pod(*mine.to_pod()).flags == mine.flags


def test_model_transform_tensors():
    mt = T.ModelTransform(pos=(1.0, 2.0, 3.0)).update(scale=(2.0, 2.0, 2.0))
    ref = J.ModelTransform(pos=(1.0, 2.0, 3.0)).update(scale=(2.0, 2.0, 2.0))
    for a, b in zip(mt.as_tensors("cpu"), ref.as_arrays()):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(nn(a), np.asarray(b))


def test_convert_carries_values(soas):
    _, ref = soas
    lj = J.ALL_LAYOUTS[4]
    pj = J.pack(ref, lj)
    layout = convert.layout_from_names(lj.sh.value, lj.cov3d.value)
    assert layout == T.ALL_LAYOUTS[4]
    pt = convert.packed_to_tensors(layout, pj.pos, pj.color, pj.sh, pj.cov3d,
                                   device="cpu")
    for f in ("pos", "color", "sh", "cov3d"):
        np.testing.assert_array_equal(nn(getattr(pt, f)), getattr(pj, f))
    jcam = J.Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=80,
                            height=64, fov_y=0.9)
    assert convert.camera_from_fields(**dataclasses.asdict(jcam)) == (
        T.Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=80,
                         height=64, fov_y=0.9))
    g = convert.gaussians_to_tensors(pj.pos, pj.pos, pj.pos, pj.pos[:, 0],
                                     device="cpu")
    assert g[4] is None and all(x.dtype == torch.float32 for x in g[:4])


def test_import_has_no_jax_nvcc_or_triton():
    """In a fresh interpreter (this one has jax): importing the port and
    chip_smoke pulls in no jax and no triton and builds nothing, and
    chip_smoke fails, printing no result, without a CUDA card."""
    code = (
        "import sys, wgpu_3dgs_core_tpu_torch as T, chip_smoke;"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'wgpu_3dgs_core_tpu')];"
        "assert not bad, bad;"
        "from wgpu_3dgs_core_tpu_torch.ops import cuda;"
        "assert cuda._library is None;"
        "print('imported');"
        "sys.exit(chip_smoke.main())"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "imported", out.stderr
    assert out.returncode not in (0, 1), out.stderr  # 1 would be a crash


def test_cpu_render_launches_no_kernel():
    T.reset_launch_counts()
    rng = np.random.default_rng(0)
    means = rng.normal(size=(12, 3)).astype(np.float32) * 0.5
    cov6 = np.tile(np.array([0.02, 0, 0, 0.02, 0, 0.02], np.float32), (12, 1))
    cam = T.Camera.look_at(eye=(0, 0, -4), target=(0, 0, 0), width=32,
                           height=32, fov_y=0.9)
    res = T.render(tt(means), tt(cov6), tt(rng.random((12, 3)), torch.float32),
                   torch.full((12,), 0.8), cam)
    assert res.image.shape == (32, 32, 3)
    assert (nn(res.transmittance) < 1).any()
    counts = T.launch_counts()
    assert set(counts) == {"expand_rows", "expand_row_table",
                           "expand_fragments", "expand_fragment_records",
                           "sorted_fetch", "rasterize_fwd",
                           "rasterize_bwd", "segment_sums", "uncompact",
                           "expand_fragments_bbox", "kernel_bundle",
                           "rasterize_variants", "segment_sum_variants",
                           "probe_dyngrid", "sh_color_fwd",
                           "sh_color_bwd"}
    assert not any(counts.values()), counts


def test_kernel_dispatch_is_by_device_only():
    cpu = torch.zeros(2)
    assert on_cpu(cpu, cpu)
    with pytest.raises(ValueError):
        on_cpu(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        on_cpu(cpu, torch.zeros(2, device="meta"))
