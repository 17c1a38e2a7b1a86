"""The torch port's measurement kernels against the JAX package's tools.

K11 (the live-bound launch probe), K10 (the segment-sum levels) and K9
(the rasterizer levels) through their plain versions on the CPU: K11
against the JAX ``tools/probe_dyngrid.py::run`` (Pallas in interpret
mode), K10's full level against the JAX ``segment_sums_sorted``, its
scanning levels bit for bit K5's plain version on the streams K5 finds
hard, and every K9 level against a numpy definition in float64, K3's
warp-block cull included; then the CUDA route of each wrapper, which
never falls back to the plain version. K9's full level against the JAX
forward kernel is in test_torch_bench.py, on the bench step's scene, and
K10's levels against numpy in test_torch_segsum.py. The kernels run on the card in
tests/test_torch_cuda.py and chip_smoke.py.

tools/bench_kernel_variants.py and tools/bench_segsum.py are not imported:
they point JAX's compilation cache into the repository when imported.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu.ops import segreduce as JS
from wgpu_3dgs_core_tpu_torch.ops import binning as TB
from wgpu_3dgs_core_tpu_torch.ops import segreduce as TS
from wgpu_3dgs_core_tpu_torch.ops.transforms import cov3d_from_rot_scale
from wgpu_3dgs_core_tpu_torch.render.renderer import project_and_color
from wgpu_3dgs_core_tpu_torch.ops import probe as K11
from wgpu_3dgs_core_tpu_torch.ops import variants as KV
from wgpu_3dgs_core_tpu_torch.ops.rasterize import frag_pixel_box_plain
from wgpu_3dgs_core_tpu_torch.tools.bench_segsum import hard_streams
from wgpu_3dgs_core_tpu_torch.tools.probe_dyngrid import SENTINEL

from .test_segreduce import _setup
from .test_torch_backward import (
    SEG_N,
    _jax_segsum,
    _port_stream,
    _segsum_counts,
)
from .torch_parity import nn, one_torch_thread, random_scene, tt  # noqa: F401

LEVEL_TOL = 1e-5  # of each tile's / row's largest value: f32 vs f64 sums


def _jax_probe_module():
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_dyngrid.py"
    spec = importlib.util.spec_from_file_location("jax_probe_dyngrid", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k11_plain_matches_jax_probe(monkeypatch):
    """The TPU probe's shape, [64, 128] f32 in [8, 128] blocks with 3 and 8
    live: the port's probe (plain on the CPU) writes JAX's live prefix and
    leaves the rest of its output as it was, in every launch form."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    jrun = jax.jit(_jax_probe_module().run)
    x = np.random.default_rng(0).random((64, 128)).astype(np.float32)
    for live in (3, 8):
        want = np.asarray(jrun(jnp.int32(live), jnp.asarray(x)))[:live * 8]
        for form in K11.FORMS:
            out = torch.full((64 * 128,), SENTINEL)
            got = K11.probe(form, tt(x).reshape(-1), out,
                            torch.tensor([live], dtype=torch.int32), 1024)
            assert got is out
            k = live * 1024
            np.testing.assert_array_equal(nn(got[:k]), want.reshape(-1))
            assert bool((got[k:] == SENTINEL).all())


def test_k10_s2_gather_plain_matches_jax_segment_sums():
    """tests/test_segreduce.py's sorted stream: the full level within 1e-5
    of each row's largest sum of JAX ``segment_sums_sorted``."""
    (dgs, keys_f), gid_mono, total, _ = _setup(
        SEG_N, _segsum_counts("seed0"), 4 * JS.SEG_BLOCK, seed=0)
    comp, _ = _jax_segsum(dgs, keys_f, gid_mono, total, SEG_N)
    comp = np.asarray(comp)
    keys, perm, grads, gid_col = _port_stream(dgs, keys_f, gid_mono, SEG_N)
    rows = gid_col.shape[0]
    want = comp.transpose(1, 0, 2).reshape(comp.shape[1], -1)[:9, :rows]
    got = nn(KV.segment_sums_level("s2_gather", keys, perm, grads, gid_col,
                                    SEG_N))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= LEVEL_TOL * scale).all()


def _permuted_stream(seed=9, n=60, f=500):
    """An unsorted stream of gradient slots (some undrawn, keyed past n),
    sorted by sort_keys: (keys, perm, grad, gid_col, n)."""
    rng = np.random.default_rng(seed)
    gauss_id = tt(rng.integers(0, n, f).astype(np.int32))
    tile_id = torch.sort(tt(rng.integers(0, 5, f).astype(np.int32))).values
    ids = torch.arange(4, dtype=torch.int32)
    start = torch.searchsorted(tile_id, ids, out_int32=True)
    end = torch.searchsorted(tile_id, ids, right=True, out_int32=True)
    draw = ((end - start) * 3 // 4).to(torch.int32)
    grad = tt(rng.normal(size=(9, f)).astype(np.float32))
    keys, perm = TS.sort_keys(gauss_id, tile_id, start, draw, n)
    live = torch.unique(keys[keys < n])
    gid_col = torch.cat([live, torch.full((n - live.shape[0],), n,
                                          dtype=torch.int32)])
    return keys, perm, grad, gid_col, n


def test_k10_full_levels_plain_equal_k5_plain_bit_for_bit():
    """s1_scan over the key-ordered gradients, s2_gather (K5) and
    s2_nostage through the permutation: K5's plain version, bit for bit,
    on the streams K5 finds hard and on a sorted unsorted stream."""
    streams = dict(hard_streams(), permuted=_permuted_stream())
    for name, (keys, perm, grad, gid_col, n) in streams.items():
        want = TS.segment_sums_sorted_plain(keys, perm, grad, gid_col, n)
        for level in ("s1_scan", "s2_gather", "s2_nostage"):
            got = KV.segment_sums_level(level, keys, perm,
                                         KV.level_operand(level, grad, perm),
                                         gid_col, n)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (name, level)


@pytest.fixture(scope="module")
def small_stream():
    """tests/test_torch_parity's random scene of 300 gaussians at 128x96,
    binned by the port: K3's arguments (frags, tile_start, draw_len, bg)."""
    means, quats, scales, color, opac, _ = random_scene(300, seed=5)
    cam = T.Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                           width=128, height=96, fov_y=0.9)
    spl, rgb, op = project_and_color(
        tt(means), cov3d_from_rot_scale(tt(quats), tt(scales)), tt(color),
        tt(opac), cam)
    attr = torch.cat([spl.xy.T, spl.conic.T, rgb.T, (op * spl.mask)[None]])
    tx, ty = TB.num_tiles(128, 96)
    stream, frags, _ = TB.bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr, tx, ty, 4096)
    sched = TB.pad_schedule(stream, TB.padded_capacity(4096, tx * ty, 1.0))
    assert int(stream.num_fragments) > 300 and not bool(stream.overflow)
    return frags, stream.tile_start, sched.draw_len, (0.1, 0.2, 0.3)


def _numpy_level(level, frags, start, length, bg, boxes, cutoff_sq=9.0):
    """Level ``level`` by its definition, in float64 per tile and pixel,
    each pixel in its warp's 8x4 block (columns 8 (c // 8) .. + 7, rows
    4 (r // 4) .. + 3): sums of the staged opacities (0); over the
    fragments whose box ``boxes`` [4, F] meets the pixel's block, sums of
    opacity (1), q (2), the kept alphas (3); the T recurrence of the kept
    fragments while T > 1e-4 (4: black fragments), with colour (5, 6),
    with 1 - q/2 for exp(-q/2) (7)."""
    f = frags.astype(np.float64)
    p = np.arange(256)
    px, py = p % 16 + 0.5, p // 16 + 0.5
    x0, y0 = p % 16 // 8 * 8, p // 16 // 4 * 4
    out = np.zeros((start.shape[0], 4, 256))
    for t, (s, ln) in enumerate(zip(start, length)):
        fr = f[:, s:s + ln]
        bx = boxes[:, s:s + ln, None]
        walked = ((bx[0] <= x0 + 7) & (bx[1] >= x0) & (bx[2] <= y0 + 3)
                  & (bx[3] >= y0))
        dx = px[None, :] - fr[0][:, None]
        dy = py[None, :] - fr[1][:, None]
        q = (fr[2][:, None] * dx * dx + 2 * fr[3][:, None] * dx * dy
             + fr[4][:, None] * dy * dy)
        fall = 1.0 - 0.5 * q if level == 7 else np.exp(-0.5 * q)
        alpha = np.minimum(fr[8][:, None] * fall, 0.99)
        keep = (q <= cutoff_sq) & (alpha >= 1.0 / 255.0)
        op = np.broadcast_to(fr[8][:, None], q.shape)
        if level == 0:
            out[t, 0] = op.sum(axis=0)
            continue
        if level <= 3:
            val = (op, q, np.where(keep, alpha, 0.0))[level - 1]
            out[t, 0] = np.where(walked, val, 0.0).sum(axis=0)
            continue
        tr, rgb = np.ones(256), np.zeros((3, 256))
        for i in range(ln):
            blend = keep[i] & (tr > 1e-4)
            if level != 4:
                rgb += np.where(blend, alpha[i] * tr, 0.0) * fr[5:8, i, None]
            tr = np.where(blend, tr * (1.0 - alpha[i]), tr)
        out[t, 0:3] = rgb + tr * np.asarray(bg)[:, None]
        out[t, 3] = tr
    return out


@pytest.mark.parametrize("name", KV.RASTER_LEVELS)
def test_k9_levels_plain_match_numpy(small_stream, name):
    """Each level within 1e-5 of each tile's largest value of its
    definition, culled by the plain boxes. v0_stage writes the box word of
    every slot it stages, and the culling levels give the same bits when
    handed those words."""
    frags, start, length, bg = small_stream
    boxes = torch.full((frags.shape[1],), -1, dtype=torch.int32)
    got = KV.rasterize_level(name, frags, start, length, bg, boxes=boxes)
    plain_box = frag_pixel_box_plain(frags)
    want = _numpy_level(KV.RASTER_LEVELS.index(name), nn(frags), nn(start),
                        nn(length), bg, nn(plain_box))
    got = nn(got)
    scale = np.abs(want).max(axis=(1, 2))
    err = np.abs(got - want).max(axis=(1, 2))
    norm = np.where(scale > 0, err / np.where(scale > 0, scale, 1), err)
    assert norm.max() <= LEVEL_TOL, (name, norm.max())
    staged = torch.zeros(frags.shape[1], dtype=torch.bool)
    for s, ln in zip(start.tolist(), length.tolist()):
        staged[s:s + ln] = True
    if name == "v1_cull":  # the plain blocks are the kernel's lanes' blocks
        pix = KV.warp_pixels()
        blocks = KV._warp_blocks("cpu")[:, pix]  # [4, 8 warps, 32 lanes]
        for k, (rows, lo) in enumerate([(pix % 16, True), (pix % 16, False),
                                        (pix // 16, True),
                                        (pix // 16, False)]):
            ext = rows.amin(dim=1) if lo else rows.amax(dim=1)
            assert torch.equal(blocks[k], ext[:, None].expand(-1, 32))
    if name == "v0_stage":
        assert torch.equal(boxes[staged], KV.box_words(plain_box)[staged])
        assert torch.equal(KV.box_rows(boxes[staged]), plain_box[:, staged])
    else:
        assert bool((boxes == -1).all())  # only v0_stage writes boxes
    by_words = KV.rasterize_level_plain(
        name, frags, start, length, bg,
        cull_boxes=KV.box_words(plain_box))
    assert torch.equal(by_words.view(torch.int32),
                       torch.from_numpy(got).view(torch.int32))


def test_cuda_route_never_falls_back(monkeypatch, small_stream):
    """With ``on_cpu`` answering False, each wrapper takes its CUDA route:
    K9 and K10 launch their C entry with the level's arguments, K11 with
    its form's grid, and none returns the plain result; without nvcc the
    route raises."""
    frags, start, length, bg = small_stream
    keys, perm, grad, gid_col, n = _permuted_stream()
    x = torch.rand(8 * 256)
    count = torch.tensor([5], dtype=torch.int32)
    for mod in (KV, K11):
        monkeypatch.setattr(mod, "on_cpu", lambda *t: False)
    for call in (
        lambda: KV.rasterize_level("v2_q", frags, start, length, bg),
        lambda: KV.segment_sums_level("s2_gather", keys, perm, grad,
                                       gid_col, n),
        lambda: K11.probe("capacity", x, torch.zeros_like(x), count, 256),
    ):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()

    launches = []
    for kernel in (KV.RASTER_LEVEL, KV.SEGSUM_LEVEL):
        monkeypatch.setattr(kernel, "launch", lambda *a, **kw: launches.append(
            (a[:2], kw["work"])))
    monkeypatch.setattr(K11, "build", lambda: T.ops.cuda.BuildInfo(
        None, 0.0, ""))
    monkeypatch.setattr(K11, "bundle_library", lambda path: None)
    monkeypatch.setattr(K11, "bind", lambda lib, sym, types: sym)
    monkeypatch.setattr(K11, "_loaded", {})
    monkeypatch.setattr(K11.PROBE, "call", lambda fn, lib, *a, **kw:
                        launches.append((fn, a[3], kw["work"])))
    KV.rasterize_level("v2_q", frags, start, length, bg)
    KV.segment_sums_level("s2_nostage", keys, perm, grad, gid_col, n)
    for form in K11.FORMS:
        out = torch.zeros_like(x)
        K11.probe(form, x, out, count, 256)
        assert not out.any()  # no plain write
    assert launches == [
        ((2, frags.data_ptr()), start.shape[0]),
        ((3, keys.data_ptr()), gid_col.shape[0]),
        ("gs_probe_capacity", 8, 8),
        ("gs_probe_readback", 5, 5),
        ("gs_probe_device_launch", 8, 8),
    ]
