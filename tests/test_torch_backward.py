"""The torch port's backward slice against the JAX package.

K4 (the rasterizer's backward), K5 and K6 (the segment sums per gaussian
and their scatter back to gaussian order) through their plain versions on
the CPU, the renderer's autograd Function, and ``render`` and
``render_reference`` gradients, each against its JAX counterpart on the
same numpy inputs (JAX Pallas kernels in interpret mode). Gradients are
compared normalized, max |port - JAX| / max |JAX| per row or parameter,
at the JAX suite's bar of 1e-4 (tests/test_render.py); K6 moves values
and must be equal bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu.ops import binning as JB
from wgpu_3dgs_core_tpu.ops import expand as JE
from wgpu_3dgs_core_tpu.ops import rasterize as JRa
from wgpu_3dgs_core_tpu.ops import segreduce as JS
from wgpu_3dgs_core_tpu.ops.transforms import (
    cov3d_from_rot_scale,
    unpack_color,
    unpack_cov3d,
)
from wgpu_3dgs_core_tpu.render import renderer as JR
from wgpu_3dgs_core_tpu_torch.convert import (
    camera_from_fields,
    gaussians_to_tensors,
)
from wgpu_3dgs_core_tpu_torch.ops import binning as TB
from wgpu_3dgs_core_tpu_torch.ops import rasterize as TR
from wgpu_3dgs_core_tpu_torch.ops import segreduce as TS
from wgpu_3dgs_core_tpu_torch.ops import transforms as TT
from wgpu_3dgs_core_tpu_torch.render.renderer import (
    BinRasterize,
    tile_local_stream,
)

from .test_rowtrim import H, W, _scene
from .test_segreduce import _setup
from .torch_parity import (  # noqa: F401
    EXAMPLE_PLY,
    nn,
    one_torch_thread,
    random_scene,
    tt,
)

GRAD_TOL = 1e-4  # normalized, tests/test_render.py:93-99
SEGSUM_TOL = dict(rtol=1e-6, atol=1e-6)  # tests/test_segreduce.py
TX, TY = JB.num_tiles(W, H)
T_TOTAL = TX * TY
F_CAP = 6656  # holds the rowtrim scene's 6516 live fragments
BG = (0.1, 0.2, 0.3)
CHUNK, GROUP = 128, 8  # the JAX renderer's schedule
F_PAD_CAP = -(-(F_CAP + T_TOTAL * CHUNK) // (CHUNK * GROUP)) * CHUNK * GROUP
# (tile_y_offset, tiles_x, tiles_y, f_cap, chunk, bg, cutoff_sq, mode,
# pad_slack, r_cap) of the JAX custom VJP, SPLAT mode.
VJP_STATIC = (0, TX, TY, F_CAP, CHUNK, BG, 9.0, 0, 1.0, None)


def assert_normalized(mine, ref, tol=GRAD_TOL, name=""):
    mine, ref = nn(mine), nn(ref)
    assert mine.shape == ref.shape, name
    scale = np.abs(ref).max() + 1e-8
    err = np.abs(mine - ref).max() / scale
    assert err <= tol, f"{name}: normalized error {err:.3g} > {tol}"


@jax.jit
def _jax_table(xy, extent, depth, mask, attr_cols):
    """The JAX per-gaussian segment table of the binning (its XLA stages,
    as tests/test_torch_binning.py::_jax_expand_stages runs them)."""
    x0, y0, _, _, span_x, span_y, live, ry = JB._exact_bounds(
        xy, extent, attr_cols[2:5].T, attr_cols[8], mask, TX, TY, 0, 9.0,
        True)
    counts = jnp.where(live & (span_x > 0), span_y, 0)
    gid = jnp.arange(xy.shape[0], dtype=jnp.int32)
    attr10 = jnp.concatenate([attr_cols, ry[None]], axis=0)
    return JE.build_tables(counts, span_x, x0, y0, gid, attr10,
                           jnp.where(mask, depth, jnp.inf))[0]


@jax.jit
def _jax_backward(mat, tab_t, num_frag, tiles0, tiles1, g_tiles, xy, extent,
                  depth, mask_f):
    """The JAX backward on residuals of the JAX renderer's layout: its
    padded schedule and window offsets (render/renderer.py:320-328), the
    backward kernel in SPLAT and ELLIPSE mode, and the SPLAT-mode backward
    rule of its custom VJP (what jax.vjp of _bin_rasterize runs)."""
    tile_sorted = mat[10, :F_CAP].astype(jnp.int32)
    ids = jnp.arange(T_TOTAL, dtype=jnp.int32)
    start = jnp.searchsorted(tile_sorted, ids, side="left").astype(jnp.int32)
    end = jnp.searchsorted(tile_sorted, ids, side="right").astype(jnp.int32)
    sched = JB.pad_schedule(
        JB.FragmentStream(None, tile_sorted, None, None, start, end), CHUNK,
        F_PAD_CAP)
    grp = CHUNK * GROUP
    src_base = jnp.clip(sched.src.reshape(-1, CHUNK)[:, 0], 0, F_CAP)
    fl = (src_base[::GROUP] // grp).astype(jnp.int32)
    off = jnp.clip(src_base - jnp.repeat(fl, GROUP) * grp, 0,
                   2 * grp - CHUNK).astype(jnp.int32)
    win = (mat, off, fl, sched.blk_flags, sched.live_blocks)
    dfrag = [JRa.rasterize_tiles_bwd(*win, tiles, g_tiles, CHUNK, T_TOTAL, BG,
                                     9.0, mode, GROUP)[0:9]
             for mode, tiles in ((0, tiles0), (1, tiles1))]
    res = (*win, tab_t, num_frag, tiles0, jnp.bool_(False), xy, extent,
           depth, mask_f)
    d_cols = JR._bin_rasterize_bwd(*VJP_STATIC, res,
                                   (g_tiles, None, None))[0]
    return dict(src=sched.src, valid=sched.valid, dfrag=dfrag, d_cols=d_cols)


@pytest.fixture(scope="module")
def binned():
    """The rowtrim scene (tests/test_rowtrim.py), binned and rasterized by
    the port (its sorted stream equals the JAX renderer's bit for bit,
    tests/test_torch_binning.py), a random cotangent of the tiles, and the
    JAX backward given the same residuals: the stream in the JAX kernel's
    [16, cols] layout (rows 0-8 the stream, 9 the gaussian id, 10 the
    tile, t_total on the tail) and the port's plain K3 tiles, whose 1e-5
    agreement with the JAX forward kernel is tested there too."""
    spl, attr = _scene()
    args = [tt(x) for x in (spl.xy, spl.extent, spl.depth, spl.mask, attr)]
    stream, attrs_sorted, _ = TB.bin_splats_attrs(*args, TX, TY, F_CAP)
    sched = TB.pad_schedule(stream, F_PAD_CAP)
    frags = tile_local_stream(attrs_sorted, stream.tile_id, TX)
    tiles = [TR.rasterize_tiles_fwd(frags, stream.tile_start, sched.draw_len,
                                    BG, 9.0, mode) for mode in (0, 1)]
    grp = CHUNK * GROUP
    mat = np.zeros((16, (-(-F_CAP // grp) + 2) * grp), np.float32)
    mat[0:9, :F_CAP] = nn(frags)
    mat[9, :F_CAP] = nn(attrs_sorted[9])
    mat[10, :F_CAP] = nn(stream.tile_id)
    mat[10, F_CAP:] = T_TOTAL
    g = np.random.default_rng(5).normal(size=(T_TOTAL, 4, 256))
    g = g.astype(np.float32)
    tab_t = _jax_table(spl.xy, spl.extent, spl.depth, spl.mask, attr)
    jax_out = _jax_backward(mat, tab_t, nn(stream.num_fragments),
                            *(nn(t) for t in tiles), g, spl.xy, spl.extent,
                            spl.depth, spl.mask.astype(jnp.float32))
    port = dict(frags=frags, stream=stream, sched=sched, tiles=tiles)
    return spl, attr, g, port, jax_out


def _by_stream(dfrag_padded, src, valid):
    """JAX's padded-schedule slots -> stream order (slots no block drew
    stay zero)."""
    src, valid = np.asarray(src), np.asarray(valid)
    out = np.zeros((9, F_CAP), np.float32)
    out[:, src[valid]] = np.asarray(dfrag_padded)[:, valid]
    return out, src[valid]


@pytest.mark.parametrize("mode", [0, 1])
def test_k4_plain_matches_jax_rasterize_tiles_bwd(binned, mode):
    """K4's plain version against the JAX backward kernel on the same
    stream, forward tiles and cotangent, per gradient row, in SPLAT and
    ELLIPSE mode; slots no block drew are exact zeros."""
    _, _, g, port, jo = binned
    stream, sched = port["stream"], port["sched"]
    mine = TR.rasterize_tiles_bwd(
        port["frags"], stream.tile_start, stream.tile_end - stream.tile_start,
        sched.draw_len, port["tiles"][mode], tt(g), BG, 9.0, mode)
    want, drawn = _by_stream(jo["dfrag"][mode], jo["src"], jo["valid"])
    assert drawn.size > 6000
    for r in range(9):
        assert_normalized(nn(mine)[r], want[r], name=f"row {r}")
    if mode == 1:  # only opacity takes gradient
        assert not nn(mine)[0:5].any() and nn(mine)[8].any()
    undrawn = np.ones(F_CAP, bool)
    undrawn[drawn] = False
    assert not nn(mine)[:, undrawn].any()


def test_bin_rasterize_function_matches_jax_vjp(binned):
    """The autograd Function's d attr_cols against the JAX custom VJP's
    backward rule on the same residuals and cotangent."""
    spl, attr, g, _, jo = binned
    a = tt(attr).requires_grad_(True)
    args = [tt(x) for x in (spl.xy, spl.extent, spl.depth, spl.mask)]
    tiles, written, overflow = BinRasterize.apply(
        a, *args, TX, TY, F_CAP, BG, 9.0, 0, 1.0, None)
    assert not bool(overflow) and bool(written.any())
    (d_cols,) = torch.autograd.grad(tiles, a, tt(g))
    for r in range(9):
        assert_normalized(nn(d_cols)[r], nn(jo["d_cols"])[r], name=f"row {r}")


def test_bin_rasterize_overflow_gives_exact_zeros(binned):
    """Capacity 4096 and no padding headroom: the stream overflows (JAX
    flags the same configuration, tests/test_torch_binning.py) and, as the
    JAX backward does, the gradient is exactly zero."""
    spl, attr, g, _, _ = binned
    a = tt(attr).requires_grad_(True)
    args = [tt(x) for x in (spl.xy, spl.extent, spl.depth, spl.mask)]
    tiles, _, overflow = BinRasterize.apply(a, *args, TX, TY, 4096, BG, 9.0,
                                            0, 0.0, None)
    assert bool(overflow)
    (d_cols,) = torch.autograd.grad(tiles, a, tt(g))
    assert not nn(d_cols).any()


def _port_stream(grads_split, keys_f, gid_mono, n):
    """test_segreduce's JAX inputs in the port's form: the f32 gradient
    rows (the exact bf16 split summed back), int32 keys with the identity
    permutation (they are sorted), and the gid column with the sentinel n
    in place of 2^24."""
    s = np.asarray(grads_split).astype(np.float32)
    grads = (s[0:9] + s[9:18]) + s[18:27]
    keys = np.asarray(keys_f).astype(np.int32)
    gid = np.asarray(gid_mono)
    gid_col = np.where(gid >= n, n, gid).astype(np.int32)
    return (tt(keys), torch.arange(keys.shape[0]), tt(grads), tt(gid_col))


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_segsum(dg_split, keys_f, gid_mono, total, n):
    comp = JS.segment_sums_sorted(dg_split, keys_f, gid_mono, total)
    return comp, JS.uncompact_columns(comp, gid_mono, n)


SEG_N = 700  # one shape for every case: one JAX compile


def _segsum_counts(case):
    rng = np.random.default_rng({"seed0": 100, "seed1": 101}.get(case, 3))
    if case in ("seed0", "seed1"):
        counts = rng.integers(0, 7, SEG_N).astype(np.int32)
        counts[rng.random(SEG_N) < 0.3] = 0
    elif case == "spans_blocks":
        counts = np.zeros(SEG_N, np.int32)
        counts[3], counts[4], counts[SEG_N - 1] = JS.SEG_BLOCK + 37, 5, 2
    elif case == "missing":
        counts = rng.integers(0, 5, SEG_N).astype(np.int32)
    else:
        counts = np.zeros(SEG_N, np.int32)
    return counts


@pytest.mark.parametrize("case", ["seed0", "seed1", "spans_blocks",
                                  "missing", "empty"])
def test_k5_k6_plain_match_jax_segment_sums(case):
    """tests/test_segreduce.py's synthetic sorted streams (two seeds, one
    gaussian spanning blocks, 200 fragments missing, no fragments): K5
    within 1e-6 of JAX segment_sums_sorted; K6 on JAX's compacted sums
    equal to JAX uncompact_columns bit for bit; the chain equal to the
    naive sums."""
    seed = {"seed0": 0, "seed1": 1, "spans_blocks": 7, "missing": 3,
            "empty": 0}[case]
    (dgs, keys_f), gid_mono, total, exp = _setup(
        SEG_N, _segsum_counts(case), 4 * JS.SEG_BLOCK, seed=seed,
        drop=200 if case == "missing" else 0)
    comp, full = (np.asarray(x) for x in
                  _jax_segsum(dgs, keys_f, gid_mono, total, SEG_N))
    keys, perm, grads, gid_col = _port_stream(dgs, keys_f, gid_mono, SEG_N)
    rows = gid_col.shape[0]
    jax_comp = comp.transpose(1, 0, 2).reshape(comp.shape[1], -1)[:9, :rows]

    mine = TS.segment_sums_sorted(keys, perm, grads, gid_col, SEG_N)
    np.testing.assert_allclose(nn(mine), jax_comp, **SEGSUM_TOL)
    back = TS.uncompact_columns(tt(jax_comp), gid_col, SEG_N)
    np.testing.assert_array_equal(nn(back), full[:9])
    chain = TS.uncompact_columns(mine, gid_col, SEG_N)
    np.testing.assert_allclose(nn(chain).T, exp, **SEGSUM_TOL)
    if case == "empty":
        assert not nn(chain).any()


def test_k5_sums_through_the_permutation():
    """K5 reads the gradient through the sort's permutation: an unsorted
    stream sorted by sort_keys gives the naive per-gaussian sums, and the
    slots the rasterizer did not draw contribute nothing."""
    rng = np.random.default_rng(9)
    n, t_total, f = 50, 4, 300
    gauss_id = tt(rng.integers(0, n, f).astype(np.int32))
    tile_id = torch.sort(tt(rng.integers(0, t_total + 1, f).astype(np.int32)))
    tile_id = tile_id.values
    ids = torch.arange(t_total, dtype=torch.int32)
    start = torch.searchsorted(tile_id, ids, out_int32=True)
    end = torch.searchsorted(tile_id, ids, right=True, out_int32=True)
    draw = ((end - start) * 2 // 3).to(torch.int32)
    grad = tt(rng.normal(size=(9, f)).astype(np.float32))
    keys, perm = TS.sort_keys(gauss_id, tile_id, start, draw, n)
    gid_col = torch.sort(torch.randperm(n, generator=torch.Generator()
                                        .manual_seed(0))[:40].int()).values
    gid_col = torch.cat([gid_col, torch.full((10,), n, dtype=torch.int32)])
    sums = TS.uncompact_columns(
        TS.segment_sums_sorted(keys, perm, grad, gid_col, n), gid_col, n)
    want = np.zeros((9, n), np.float32)
    slot = np.arange(f)
    t = nn(tile_id)
    tc = np.minimum(t, t_total - 1)
    drawn = (t < t_total) & (slot - nn(start)[tc] < nn(draw)[tc])
    held = np.isin(nn(gauss_id), nn(gid_col))
    for s in np.nonzero(drawn & held)[0]:
        want[:, nn(gauss_id)[s]] += nn(grad)[:, s]
    np.testing.assert_allclose(nn(sums), want, **SEGSUM_TOL)


JCAM = J.Camera.look_at(eye=(0, 0, -5), target=(0, 0, 0), width=64,
                        height=48, fov_y=0.8)
CAM = camera_from_fields(**dataclasses.asdict(JCAM))
NAMES = ("means", "quats", "scales", "color", "opac", "sh")


@functools.partial(jax.jit, static_argnames=("kw",))
def _jax_reference_grads(args, target, kw):
    """jax.grad of sum((image - target)^2) of the JAX render_reference
    w.r.t. every argument."""
    def loss(args):
        means, quats, scales, color, opac, sh = args
        img = J.render_reference(means, cov3d_from_rot_scale(quats, scales),
                                 color, opac, JCAM, sh=sh, **dict(kw))
        return jnp.sum((img - target) ** 2)

    return jax.grad(loss)(args)


def _port_grads(args, loss_of, tiled, **kw):
    """Torch autograd through the port's render (``tiled``) or
    render_reference of ``loss_of(image, transmittance or None)``, w.r.t.
    every argument that is not None (zeros where unused)."""
    ts = [None if x is None else tt(x).requires_grad_(True) for x in args]
    means, quats, scales, color, opac, sh = ts
    cov6 = TT.cov3d_from_rot_scale(quats, scales)
    if tiled:
        res = T.render(means, cov6, color, opac, CAM, sh=sh, **kw)
        assert not bool(res.overflow)
        loss = loss_of(res.image, res.transmittance)
    else:
        img = T.render_reference(means, cov6, color, opac, CAM, sh=sh, **kw)
        loss = loss_of(img, None)
    live = [t for t in ts if t is not None]
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(live, grads)]


def _assert_grads(mine, ref, names=NAMES):
    for name, a, b in zip(names, mine, ref):
        assert_normalized(a, b, name=name)


@pytest.fixture(scope="module")
def scene20():
    """tests/test_render.py::test_gradients_match_reference_autodiff's
    scene (20 gaussians, sh_deg 3) and jax.grad of the JAX
    render_reference's loss on it."""
    args = random_scene(20, seed=2)
    target = np.random.default_rng(3).random((48, 64, 3)).astype(np.float32)
    kw = (("background", BG), ("sh_deg", 3))
    return args, target, kw, _jax_reference_grads(args, target, kw)


def _l2(target):
    return lambda img, _: ((img - tt(target)) ** 2).sum()


def test_render_grads_match_jax(scene20):
    """The port's render gradients for every parameter against jax.grad
    of the JAX render_reference, which the JAX suite holds the JAX
    render's gradients to at the same bar."""
    args, target, kw, ref = scene20
    mine = _port_grads(args, _l2(target), True, **dict(kw))
    _assert_grads(mine, ref)


def test_render_reference_grads_match_jax(scene20):
    """Torch autograd of the port's render_reference (the card's gradient
    reference in chip_smoke.py) against jax.grad of the JAX one."""
    args, target, kw, ref = scene20
    mine = _port_grads(args, _l2(target), False, **dict(kw))
    _assert_grads(mine, ref)


def test_render_grads_saturating_scene():
    """tests/test_render.py::test_gradients_saturating_scene's dense opaque
    scene, whose tiles saturate early, so K4 stops before the end of most
    tiles: render gradients against jax.grad of the JAX render_reference.
    """
    n = 300
    rng = np.random.default_rng(7)
    means = np.concatenate([rng.normal(scale=0.15, size=(n, 2)),
                            rng.uniform(-1.0, 1.0, (n, 1))],
                           axis=1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = (0.08 + 0.1 * rng.random((n, 3))).astype(np.float32)
    color = rng.random((n, 3)).astype(np.float32)
    opac = np.full((n,), 0.95, np.float32)
    target = rng.random((48, 64, 3)).astype(np.float32)
    args = (means, quats, scales, color, opac, None)
    kw = (("background", BG),)
    ref = _jax_reference_grads(args, target, kw)
    mine = _port_grads(args, _l2(target), True, **dict(kw))
    _assert_grads(mine, ref[:5])


def test_transmittance_gradient():
    """tests/test_render.py::test_transmittance_gradient: d sum(T_final)
    flows through the rasterizer's fourth channel, is finite and never
    positive in opacity; it equals the gradient of the port's
    render_reference (held to the JAX one above) of a black scene on a
    white background, whose image is T_final."""
    means, quats, scales, _, opac, _ = random_scene(10, seed=4)
    args = (means, quats, scales, np.zeros_like(means), opac, None)
    mine = _port_grads(args, lambda _, trans: trans.sum(), True)
    ref = _port_grads(args, lambda img, _: img[..., 0].sum(), False,
                      background=(1.0, 1.0, 1.0))
    g = nn(mine[4])
    assert np.isfinite(g).all() and (g <= 1e-6).all() and (g < 0).any()
    _assert_grads(mine[:3] + mine[4:], ref[:3] + ref[4:],
                  names=("means", "quats", "scales", "opac"))


def test_grads_finite_with_unvisited_padding():
    """tests/test_render.py::test_gradients_finite_with_unvisited_padding_
    blocks on the repo's examples/model.ply: far fewer live fragments than
    the stream's capacity; the opacity gradient is finite and equals the
    JAX render_reference's (atol 1e-7, that test's bar)."""
    soa = J.GaussianSoA.from_ply(J.read_ply(str(EXAMPLE_PLY)))
    packed = J.GaussiansBuffer.new(soa).data
    cov6 = unpack_cov3d(packed.cov3d, rot_scale=True)
    color = unpack_color(packed.color)
    jcam = J.Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=160,
                            height=120, fov_y=0.9)
    bg = (1.0, 1.0, 1.0)

    def loss_ref(op):
        img = J.render_reference(packed.pos, cov6, color[:, 0:3], op, jcam,
                                 background=bg)
        return jnp.mean((img - 0.5) ** 2)

    g_ref = np.asarray(jax.jit(jax.grad(loss_ref))(color[:, 3]))
    means, c6, col, op, _ = gaussians_to_tensors(
        packed.pos, cov6, color[:, 0:3], color[:, 3], device="cpu")
    op.requires_grad_(True)
    res = T.render(means, c6, col, op,
                   camera_from_fields(**dataclasses.asdict(jcam)),
                   background=bg)
    (g,) = torch.autograd.grad(torch.mean((res.image - 0.5) ** 2), op)
    assert np.isfinite(nn(g)).all() and nn(g).any()
    np.testing.assert_allclose(nn(g), g_ref, atol=1e-7, rtol=0)
