"""The torch port's CUDA kernels on the card (marker ``cuda``): the
forward kernels K1-K3 and the backward kernels K4-K6 against their plain
versions, launch counts, and the determinism of the backward; K7
(one-level binning) and K8 (kernel bundles on phase 10's shapes of
chip_smoke.py, the gaussian unpack of every layout) against their plain
versions; the measurement path's K9 (rasterizer levels: v6_full against
K3), K10 (segment-sum levels: s1_scan, s2_gather and s2_nostage against
K5) and K11 (every live-bound launch form); K5 on the streams its design
finds hard.

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
from wgpu_3dgs_core_tpu_torch.ops import unpack_bundle as UB
from wgpu_3dgs_core_tpu_torch.ops.binning import (
    bbox_table, bin_splats, bin_splats_attrs, count_fragments,
    gaussian_table, num_tiles, pad_schedule, row_table,
)
from wgpu_3dgs_core_tpu_torch.ops.transforms import (
    unpack_color, unpack_cov3d, unpack_sh,
)
from wgpu_3dgs_core_tpu_torch.ops.projection import project
from wgpu_3dgs_core_tpu_torch.ops.transforms import cov3d_from_rot_scale
from wgpu_3dgs_core_tpu_torch.ops import probe as K11
from wgpu_3dgs_core_tpu_torch.ops import variants as KV
from wgpu_3dgs_core_tpu_torch.tools.bench_segsum import (
    HARD_STREAMS,
    hard_streams,
)
from wgpu_3dgs_core_tpu_torch.tools.expand_tables import (
    HARD_TABLES,
    hard_tables,
)
from wgpu_3dgs_core_tpu_torch.tools.probe_dyngrid import SENTINEL

pytestmark = pytest.mark.cuda

W, H = 256, 192
CAM = T.Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                       width=W, height=H, fov_y=0.9)
BG = (0.1, 0.2, 0.3)
FORWARD_KERNELS = ("expand_row_table", "expand_fragment_records",
                   "sorted_fetch", "rasterize_fwd")
RENDER_KERNELS = FORWARD_KERNELS + ("rasterize_bwd", "segment_sums",
                                    "uncompact")


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
    stream, frags, _ = bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr, tx, ty, 8192,
        opacity_cull=mode != 1,
    )
    sched = pad_schedule(stream, 8192 + tx * ty * 128)
    args = (frags, stream.tile_start, sched.draw_len, BG, 9.0, mode)
    got = TR.rasterize_tiles_fwd(*args)
    want = TR.rasterize_tiles_fwd_plain(*args)
    assert float((got - want).abs().max()) <= 3e-5


def _backward_inputs(cuda, mode):
    """K4's, K5's and K6's inputs on the scene's stream, with a random
    cotangent of K3's output."""
    spl, attr, tx, ty = _binned(cuda)
    stream, frags, table = bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr, tx, ty, 8192,
        opacity_cull=mode != 1,
    )
    sched = pad_schedule(stream, 8192 + tx * ty * 128)
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
    assert all(counts[k] == 1 for k in RENDER_KERNELS), counts
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
    assert T.launch_counts() == {"expand_rows": 0, "expand_row_table": 1,
                                 "expand_fragments": 0,
                                 "expand_fragment_records": 1,
                                 "sorted_fetch": 1,
                                 "rasterize_fwd": 1, "rasterize_bwd": 0,
                                 "segment_sums": 0, "uncompact": 0,
                                 "expand_fragments_bbox": 0,
                                 "kernel_bundle": 0, "rasterize_variants": 0,
                                 "segment_sum_variants": 0,
                                 "probe_dyngrid": 0,
                                 "sh_color_fwd": 0, "sh_color_bwd": 0}
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


def test_bin_splats_k7_equals_plain(cuda):
    """K7 bit for bit against its plain version, and the whole one-level
    stream on the card against the same stream on the CPU."""
    spl, _, tx, ty = _binned(cuda)
    cap = -(-int(count_fragments(spl.xy, spl.extent, spl.mask, tx, ty))
            * 3 // 2 // 512) * 512
    T.reset_launch_counts()
    got = bin_splats(spl.xy, spl.extent, spl.depth, spl.mask, tx, ty, cap)
    torch.cuda.synchronize()
    assert T.launch_counts()["expand_fragments_bbox"] == 1
    want = bin_splats(*(t.cpu() for t in (spl.xy, spl.extent, spl.depth,
                                          spl.mask)), tx, ty, cap)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert not bool(got.overflow) and int(got.num_fragments) > 0
    n = spl.xy.shape[0]
    counts = torch.randint(0, 9, (n,), device=cuda, dtype=torch.int32)
    off = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    spans = torch.randint(1, 4, (n,), device=cuda, dtype=torch.int32)
    table = TE.build_segment_table(off, counts, spans, spans, spans,
                                   torch.arange(n, device=cuda,
                                                dtype=torch.int32))
    total = counts.sum(dtype=torch.int32)
    for f_cap in (int(total) - 100, int(total) + 777):
        k = TE.expand_fragments(table, total, f_cap, tx, tx * ty)
        p = TE.expand_fragments_plain(table, total, f_cap, tx, tx * ty)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize("name", ("scene",) + HARD_TABLES)
def test_k7_equals_plain(cuda, name):
    """K7's merge-path design bit for bit its plain version, on this
    file's scene and on the tables tools/expand_tables.py makes hard for
    it."""
    if name == "scene":
        spl, _, tx, ty = _binned(cuda)
        table, total = bbox_table(spl.xy, spl.extent, spl.mask, tx, ty)
        args = (table, total, int(total) * 3 // 2 + 5, tx, tx * ty)
    else:
        args = hard_tables(cuda)[name]
    T.reset_launch_counts()
    got = TE.expand_fragments(*args)
    torch.cuda.synchronize()
    assert T.launch_counts()["expand_fragments_bbox"] == 1
    want = TE.expand_fragments_plain(*args)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def _times(k):
    def body(x, out):
        out[...] = x[...] * float(k)
    return body


MAP_ADD = T.BundleKernel(cuda="""
__device__ void map_add(const float* a, const float* b, float* out) {
  out[0] = __fmul_rn(__fadd_rn(a[0], b[0]), scale);
}""", entry="map_add", plain=lambda a, b, out, *, scale=1.0: out.copy_(
    (a + b) * scale))
SUM_PROD = T.BundleKernel(cuda="""
__device__ void sum_prod(const float* a, const float* b, const float* c,
                         float* s, float* p) {
  s[0] = __fadd_rn(__fadd_rn(a[0], b[0]), c[0]);
  p[0] = __fmul_rn(__fmul_rn(a[0], b[0]), c[0]);
}""", entry="sum_prod", plain=lambda a, b, c, s, p: (
    s.copy_(a + b + c), p.copy_(a * b * c)))
TIMES2 = T.BundleKernel(cuda="""
__device__ void times2(const float* x, float* out) {
  for (int j = 0; j < 8; ++j) out[j] = __fmul_rn(x[j], 2.0f);
}""", entry="times2", plain=_times(2))
WIDEN = T.BundleKernel(cuda="""
__device__ void widen(const uint8_t* x, float* out) {
  for (int j = 0; j < 3; ++j) out[j] = float(x[j]);
}""", entry="widen", plain=lambda x, out: out.copy_(x.float()))
CASTS = T.BundleKernel(cuda="""
__device__ void casts(const __half* h, const int8_t* q, const uint8_t* c,
                      float* oh, float* oq, float* oc) {
  gs::unpack_cov3d_half(h, oh);
  gs::unpack_sh_norm8(q, oq);
  gs::unpack_color(c, oc);
}""", entry="casts", plain=lambda h, q, c, oh, oq, oc: (
    oh.copy_(unpack_cov3d(h, rot_scale=False)),
    oq.copy_(unpack_sh(q, q.shape[0], q.device).reshape(-1, 45)),
    oc.copy_(unpack_color(c))))


def _bundle(kernel, arity, widths, block, **constants):
    bld = (T.KernelBundleBuilder().resource_layout(
        T.ResourceGroupLayout("inputs", arity)).kernel(kernel)
        .block_size(block).constants(**constants))
    for w in widths:
        bld.output(w)
    return bld


def test_bundle_shapes_equal_plain(cuda):
    """K8 (a block per tile, bulk async copies) on the shapes of
    chip_smoke.py's phase 10, bit for bit the plain launcher on CPU copies:
    owned and caller-managed resources, an
    update_resources, constants, several outputs, [N, 8] rows, f16/i8/u8
    casts, 3-byte rows at an odd address (no bulk copy), and a count below
    one tile (the ragged path alone)."""
    n = 66_773
    rng = np.random.default_rng(10)

    def dev(x):
        return torch.from_numpy(x).to(cuda)

    a, b, c = (dev(rng.normal(size=n).astype(np.float32)) for _ in range(3))
    x8 = dev(rng.normal(size=(n, 8)).astype(np.float32))
    half = dev(rng.normal(size=(n, 6)).astype(np.float16))
    norm8 = dev(rng.integers(-128, 128, (n, 48), dtype=np.int8))
    rgba = dev(rng.integers(0, 256, (n, 4), dtype=np.uint8))
    odd = dev(rng.integers(0, 256, (n + 1, 3), dtype=np.uint8))[1:]
    assert odd.data_ptr() % 16 == 3
    update = _bundle(MAP_ADD, 2, (1,), 1024).build([[c, c]])
    update.update_resources([[a, c]])
    cases = [
        (_bundle(MAP_ADD, 2, (1,), 256).build([[a, b]]), None, [[a, b]], n),
        (_bundle(MAP_ADD, 2, (1,), 64, scale=10.0).build([[a, b]]), None,
         [[a, b]], n),
        (update, None, [[a, c]], n),
        (_bundle(SUM_PROD, 3, (1, 1), 64).build([[a, b, c]]), None,
         [[a, b, c]], n),
        (_bundle(TIMES2, 1, (8,), 32).build([[x8]]), None, [[x8]], n),
        (_bundle(CASTS, 3, (6, 45, 4), 256).build([[half, norm8, rgba]]),
         None, [[half, norm8, rgba]], n),
        (_bundle(WIDEN, 1, (3,), 64).build([[odd]]), None, [[odd]], n),
        (_bundle(MAP_ADD, 2, (1,), 128).build_without_resources(),
         [[b, c]], [[b, c]], n),
        (_bundle(MAP_ADD, 2, (1,), 256).build_without_resources(),
         [[a[:1000], b[:1000]]], [[a[:1000], b[:1000]]], 1000),
    ]
    for bundle, res, used, count in cases:
        T.reset_launch_counts()
        got = bundle.dispatch(count, res)
        torch.cuda.synchronize()
        assert T.launch_counts()["kernel_bundle"] == 1
        got = got if isinstance(got, tuple) else (got,)
        want = bundle.dispatch(count, [[t.cpu() for t in g] for g in used])
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


def test_unpack_bundle_equals_plain(cuda):
    """K8 running the gaussian unpack of every layout: bit for bit against
    the port's plain unpack, before and after update_range."""
    for layout in T.ALL_LAYOUTS:
        _check_unpack_bundle(cuda, layout)


def _check_unpack_bundle(cuda, layout):
    rng = np.random.default_rng(5)
    n = 3001

    def soa(k):
        q = rng.normal(size=(k, 4)).astype(np.float32)
        return T.GaussianSoA(
            rot=q / np.linalg.norm(q, axis=1, keepdims=True),
            pos=rng.normal(size=(k, 3)).astype(np.float32),
            color=rng.integers(0, 256, (k, 4)).astype(np.uint8),
            sh=rng.normal(size=(k, 15, 3)).astype(np.float32),
            scale=rng.uniform(0.01, 0.2, (k, 3)).astype(np.float32))

    buf = T.GaussiansBuffer.new(soa(n), layout, cuda)
    mt = T.ModelTransform(pos=(0.3, -0.2, 0.5), rot=(0.1, 0.2, 0.3, 0.927),
                          scale=(1.2, 0.8, 1.1))
    bundle = UB.unpack_bundle(buf, mt)
    for _ in range(2):
        T.reset_launch_counts()
        got = bundle.dispatch(n)
        torch.cuda.synchronize()
        assert T.launch_counts()["kernel_bundle"] == 1
        d = buf.data
        want = UB.unpack_plain(d.pos, d.color, d.sh, d.cov3d, layout, mt)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        buf.update_range(1000, soa(700))


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("mode", [0, 1])
def test_k9_v6_full_equals_k3(cuda, mode):
    """K9's full level is K3 bit for bit; every other level is within 1e-5
    of each tile's largest value of its plain version, culled by the
    boxes v0_stage wrote, which are the plain mirror's to one pixel."""
    spl, attr, tx, ty = _binned(cuda)
    stream, frags, _ = bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr, tx, ty, 8192,
        opacity_cull=mode != 1,
    )
    sched = pad_schedule(stream, 8192 + tx * ty * 128)
    args = (frags, stream.tile_start, sched.draw_len, BG, 9.0, mode)
    k3 = TR.rasterize_tiles_fwd(*args)
    boxes = torch.empty(frags.shape[1], dtype=torch.int32, device=cuda)
    KV.rasterize_level("v0_stage", *args, boxes=boxes)
    staged = KV.staged_slots(stream.tile_start, sched.draw_len)
    mirror = TR.frag_pixel_box_plain(frags[:, staged], 9.0, mode)
    assert int((KV.box_rows(boxes[staged]) - mirror).abs().max()) <= 1
    for level in KV.RASTER_LEVELS:
        got = KV.rasterize_level(level, *args)
        if level == "v6_full":
            assert torch.equal(_bits(got), _bits(k3))
            continue
        want = KV.rasterize_level_plain(level, *args, cull_boxes=boxes)
        err = (got - want).abs().amax(dim=(1, 2))
        scale = want.abs().amax(dim=(1, 2))
        assert float(torch.where(scale > 0, err / scale, err).max()) <= 1e-5


def test_k10_s2_gather_equals_k5(cuda):
    """K10's levels on the backward's own stream: s0_prep writes the
    gradients slot-major and zeros, s1_scan, s2_gather and s2_nostage are
    K5 bit for bit, and every level is within 1e-5 of its plain version."""
    k4, (keys, perm, gid_col, n) = _backward_inputs(cuda, 0)
    dfrag = TR.rasterize_tiles_bwd(*k4)
    k5 = TS.segment_sums_sorted(keys, perm, dfrag, gid_col, n)
    for level in KV.SEGSUM_LEVELS:
        grad = KV.level_operand(level, dfrag, perm)
        grad_t = torch.empty((grad.shape[1], 9), device=cuda)
        row_of = torch.empty(n, dtype=torch.int32, device=cuda)
        got = KV.segment_sums_level(level, keys, perm, grad, gid_col, n,
                                     scratch=(grad_t, row_of))
        want = KV.segment_sums_level_plain(level, keys, perm, grad,
                                            gid_col, n)
        assert _normalized(got, want) <= 1e-5
        if level == "s0_prep":
            assert not bool(got.any())
            assert torch.equal(_bits(grad_t), _bits(grad.T.contiguous()))
        else:
            assert torch.equal(_bits(got), _bits(k5)), level


@pytest.mark.parametrize("name", HARD_STREAMS)
def test_k5_on_hard_streams(cuda, name):
    """K5 on the streams its design finds hard (tests/test_torch_segsum.py
    holds their plain sums to numpy and JAX): within 1e-5 of each row's
    largest sum of its plain version, exact zeros in the rows no run
    reaches, and the same bits from two launches."""
    keys, perm, grad, gid_col, n = hard_streams(device=cuda)[name]
    got = TS.segment_sums_sorted(keys, perm, grad, gid_col, n)
    again = TS.segment_sums_sorted(keys, perm, grad, gid_col, n)
    want = TS.segment_sums_sorted_plain(keys, perm, grad, gid_col, n)
    assert _normalized(got, want) <= 1e-5
    reached = torch.isin(gid_col, keys[keys < n])
    assert not bool(got[:, ~reached].any())
    assert torch.equal(_bits(got), _bits(again))


@pytest.mark.parametrize("form", K11.FORMS)
def test_k11_forms_write_the_live_prefix(cuda, form):
    """Every launch form writes x + 1 on the live blocks and leaves the
    rest of the output untouched, at the TPU probe's shape (3 and 8 of 8
    blocks of 1024) and with more live blocks than the capacity."""
    x = torch.rand(8 * 1024, device=cuda)
    for live in (3, 8, 11):
        count = torch.tensor([live], dtype=torch.int32, device=cuda)
        before = K11.PROBE.launches
        got = K11.probe(form, x, torch.full_like(x, SENTINEL), count,
                        1024)
        torch.cuda.synchronize()
        assert K11.PROBE.launches == before + 1
        k = min(live, 8) * 1024
        assert torch.equal(got[:k], x[:k] + 1.0)
        assert bool((got[k:] == SENTINEL).all())
