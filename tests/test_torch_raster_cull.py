"""The pixel-box cull of the port's rasterizer kernels (K3, K4) on the CPU.

K3 and K4 skip, a warp at a time, the fragments whose conservative pixel
box (``csrc/blend.cuh::frag_pixel_box``, mirrored in f32 by
``ops/rasterize.py::frag_pixel_box_plain``) misses the warp's pixels. That
is only right if every (fragment, pixel) pair ``_frag_alpha`` keeps lies
in the box, under the kernels' own rounding. These tests hold the mirror
to that on the tiles the cull finds hard
(``tools/bench_kernel_variants.py::hard_tiles``), on seeded random
fragments and on the rowtrim scene's stream, in SPLAT and ELLIPSE mode;
show that masking plain K3 with the boxes changes no bit of its output;
and hold plain K3 and K4 on the hard tiles to the JAX package's jnp blend
(``_chunk_alphas`` and ``render/reference.py::blend_weights``): images
within 3e-5, gradients within 1e-4 of each row's largest value.

Where alpha ties the 0.99 clamp, the kernels, their plain versions and the
TPU kernel (its ``alpha_raw < ALPHA_CLAMP`` mask) give alpha no gradient,
and ``jnp.minimum`` gives it half. The jnp reference here takes the TPU
kernel's rule; the hard tiles' tie set shows the jnp rule's difference,
which falls on the tied fragments alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_core_tpu.ops import rasterize as JRa
from wgpu_3dgs_core_tpu.render import reference as JRef
from wgpu_3dgs_core_tpu_torch.ops import binning as TB
from wgpu_3dgs_core_tpu_torch.ops import rasterize as TR
from wgpu_3dgs_core_tpu_torch.tools.bench_kernel_variants import (
    HARD_TILES,
    cull_counts,
    hard_tiles,
)

from .test_rowtrim import H, W, _scene
from .torch_parity import IMAGE_ATOL, nn, one_torch_thread, tt  # noqa: F401

GRAD_TOL = 1e-4  # normalized, tests/test_render.py:93-99
BG = (0.1, 0.2, 0.3)
MODES = [0, 1]


def _pixels():
    p = torch.arange(TR.PIX)
    return (p % 16).float() + 0.5, torch.div(p, 16,
                                             rounding_mode="floor").float() + 0.5


def _in_box(frags, mode):
    """[F, 256]: pixel inside its fragment's box."""
    px, py = _pixels()
    box = TR.frag_pixel_box_plain(frags, 9.0, mode)[..., None]
    ix, iy = px - 0.5, py - 0.5
    return ((ix >= box[0]) & (ix <= box[1]) & (iy >= box[2])
            & (iy <= box[3]))


def assert_box_covers(frags, mode):
    """Every pair _frag_alpha keeps lies in the fragment's box; returns
    (kept pairs, pairs in a box)."""
    px, py = _pixels()
    _, ok = TR._frag_alpha(frags[..., None], px, py, 9.0, mode)
    inside = _in_box(frags, mode)
    missed = ok & ~inside
    assert not bool(missed.any()), (
        f"{int(missed.sum())} kept pairs outside their box, fragments "
        f"{torch.nonzero(missed.any(dim=1)).flatten()[:8].tolist()}")
    return int(ok.sum()), int(inside.sum())


def _random_fragments(n=20000, seed=11):
    """Fragments of every size, shape, angle and opacity, centred in and
    around the tile (x, y tile-local)."""
    rng = np.random.default_rng(seed)
    sx = np.exp(rng.uniform(np.log(0.2), np.log(40.0), n))
    sy = sx * np.exp(rng.uniform(np.log(1e-3), 0.0, n))
    th = rng.uniform(0.0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    ia, ib = 1.0 / sx ** 2, 1.0 / sy ** 2
    a = ia * cs * cs + ib * sn * sn
    b = (ia - ib) * cs * sn
    c = ia * sn * sn + ib * cs * cs
    op = np.where(rng.random(n) < 0.3, rng.uniform(0.0, 0.02, n),
                  rng.uniform(0.0, 1.0, n))
    f = np.stack([rng.uniform(-24.0, 40.0, n), rng.uniform(-24.0, 40.0, n),
                  a, b, c, *rng.random((3, n)), op])
    return torch.from_numpy(f.astype(np.float32))


@pytest.fixture(scope="module")
def rowtrim_streams():
    """The rowtrim scene (tests/test_rowtrim.py) binned by the port, per
    mode as the renderer bins it (ELLIPSE without the opacity cull): K3's
    (frags, tile_start, draw_len)."""
    spl, attr = _scene()
    args = [tt(x) for x in (spl.xy, spl.extent, spl.depth, spl.mask, attr)]
    tx, ty = TB.num_tiles(W, H)
    out = {}
    for mode in MODES:
        stream, frags, _ = TB.bin_splats_attrs(
            *args, tx, ty, 8192, opacity_cull=mode != 1)
        assert not bool(stream.overflow)
        sched = TB.pad_schedule(stream, 8192 + tx * ty * 128)
        out[mode] = (frags, stream.tile_start, sched.draw_len)
    return out


@pytest.fixture(scope="module")
def tiles():
    return hard_tiles()


@pytest.mark.parametrize("mode", MODES)
def test_box_covers_kept_pairs_on_hard_tiles(tiles, mode):
    for name in HARD_TILES:
        frags = tiles[name][0]
        kept, inside = assert_box_covers(frags, mode)
        assert inside >= kept


@pytest.mark.parametrize("mode", MODES)
def test_box_covers_kept_pairs_on_random_fragments(mode):
    frags = _random_fragments()
    kept, inside = assert_box_covers(frags, mode)
    # The cull must cull: most of the 256 pixels of a small splat lie
    # outside its box.
    assert kept > 0 and inside < 0.5 * TR.PIX * frags.shape[1]


@pytest.mark.parametrize("mode", MODES)
def test_box_covers_kept_pairs_on_rowtrim_stream(rowtrim_streams, mode):
    frags, start, draw_len = rowtrim_streams[mode]
    live = int(start[-1] + draw_len[-1])
    kept, _ = assert_box_covers(frags[:, :live], mode)
    assert kept > 0


def _plain_k3_masked(frags, tile_start, tile_len, mode):
    """Plain K3 with every pair outside its fragment's box dropped before
    the blend."""
    px, py = _pixels()
    inside = _in_box(frags, mode)
    bgv = torch.tensor(BG)[:, None]
    out = torch.empty((tile_start.shape[0], 4, TR.PIX))
    tiles = torch.arange(tile_start.shape[0])
    for b, valid, idx in TR._tile_batches(tile_start, tile_len, tiles):
        f = frags[:, idx][..., None]
        alpha, ok = TR._frag_alpha(f, px, py, 9.0, mode)
        ok = ok & inside[idx] & valid[..., None]
        w, t_final = TR.blend_weights(torch.where(ok, alpha, 0.0), dim=1)
        rgb = (w[:, None] * f[5:8].movedim(0, 1)).sum(dim=2)
        out[b] = torch.cat([rgb + t_final[:, None] * bgv, t_final[:, None]],
                           dim=1)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_masked_plain_k3_equals_plain_k3(tiles, rowtrim_streams, mode):
    streams = [tiles[name] for name in HARD_TILES]
    streams.append(rowtrim_streams[mode])
    for frags, start, length in streams:
        want = TR.rasterize_tiles_fwd_plain(frags, start, length, BG, 9.0,
                                            mode)
        got = _plain_k3_masked(frags, start, length, mode)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _jax_tiles(mode, k, tpu_clamp=True):
    """The JAX package's jnp blend of a batch of tiles of ``k`` fragment
    slots each: _chunk_alphas for alpha, render/reference.py's
    blend_weights for the front-to-back weights, and its VJP. With
    ``tpu_clamp``, alpha takes no gradient where it reaches the clamp,
    ties included, as in the TPU kernel (rasterize.py's ``live_a``);
    without, jnp.minimum's half gradient at a tie. Run op by op (no jit):
    a fused XLA computation may contract q's products and sums into FMAs,
    which moves q across the cutoff and ring edges these tiles put exactly
    on pixel centres."""

    def one(frag, valid, g):
        def blend(f9):
            alpha, alpha_raw, _, ok, _, _, _ = JRa._chunk_alphas(
                f9, valid, k, 9.0, mode)  # [P, K]
            if tpu_clamp:
                alpha = jnp.where(
                    ok & (alpha_raw < JRa.ALPHA_CLAMP), alpha_raw,
                    jax.lax.stop_gradient(alpha))
            w, t_final = JRef.blend_weights(alpha.T)
            rgb = jnp.einsum("kp,ck->cp", w, f9[5:8],
                             precision=jax.lax.Precision.HIGHEST)
            bgv = jnp.asarray(BG, jnp.float32)[:, None]
            return jnp.concatenate([rgb + t_final[None] * bgv,
                                    t_final[None]], axis=0)

        out, vjp = jax.vjp(blend, frag)
        return out, vjp(g)[0]

    def run(*args):
        with jax.disable_jit():
            return jax.vmap(one)(*args)

    return run


def _normalized_cols(mine, ref):
    """[K]: each column's largest error over the largest value of its row
    (per tile), the tolerance's measure."""
    scale = np.abs(ref).max(axis=1, keepdims=True)
    return (np.abs(mine - ref) / np.where(scale > 0, scale, 1)).max(axis=0)


@pytest.mark.parametrize("mode", MODES)
def test_hard_tiles_plain_k3_k4_match_jax(tiles, mode):
    """Plain K3 within 3e-5 and plain K4 within 1e-4 (of each gradient
    row's largest value, per tile) of the JAX jnp blend and its VJP with
    the TPU kernel's clamp rule, on every hard tile, with a seeded
    cotangent. On the tie set, jnp.minimum's rule differs from it past the
    tolerance on the tied fragments and on no other."""
    rng = np.random.default_rng(17 + mode)
    k = max(int(t[2].max()) for t in tiles.values())
    run = _jax_tiles(mode, k)
    for name in HARD_TILES:
        frags, start, length = tiles[name]
        n_t = start.shape[0]
        g_out = rng.normal(size=(n_t, 4, TR.PIX)).astype(np.float32)
        out = TR.rasterize_tiles_fwd_plain(frags, start, length, BG, 9.0,
                                           mode)
        dfrag = TR.rasterize_tiles_bwd_plain(frags, start, length, length,
                                             out, torch.from_numpy(g_out),
                                             BG, 9.0, mode)
        f = np.zeros((n_t, 9, k), np.float32)
        valid = np.zeros((n_t, 1, k), bool)
        for t, (s, ln) in enumerate(zip(nn(start), nn(length))):
            f[t, :, :ln] = nn(frags)[:, s:s + ln]
            valid[t, 0, :ln] = True
        args = (jnp.asarray(f), jnp.asarray(valid), jnp.asarray(g_out))
        j_out, j_d = run(*args)
        err = np.abs(nn(out) - np.asarray(j_out)).max()
        assert err <= IMAGE_ATOL, (name, err)
        j_d = np.asarray(j_d)
        for t, (s, ln) in enumerate(zip(nn(start), nn(length))):
            norm = _normalized_cols(nn(dfrag)[:, s:s + ln], j_d[t, :, :ln])
            assert norm.max() <= GRAD_TOL, (name, t, norm.max())
        if name == "tie":
            j_half = np.asarray(_jax_tiles(mode, k, tpu_clamp=False)(*args)[1])
            tied = f[:, 8] == np.float32(JRa.ALPHA_CLAMP)  # [T, K]
            off = np.stack([_normalized_cols(j_half[t], j_d[t])
                            for t in range(n_t)])
            assert off[tied].max() > GRAD_TOL
            assert off[~tied].max() <= GRAD_TOL


def test_box_special_cases():
    """The unit circle's box is the pixels within 3 of its centre; a
    fragment below the 1/255 floor gets the empty box in both modes;
    non-finite values, a conic that is not positive definite and one too
    thin to bound get the whole tile."""
    # x, y, conic a, b, c, opacity of each case.
    cases = [(8.0, 8.0, 1.0, 0.0, 1.0, 0.99),  # the unit circle
             (8.0, 8.0, 1.0, 0.0, 1.0, np.float32(1.0 / 255.0) * 0.999),
             (8.0, 8.0, np.nan, 0.0, 1.0, 0.5),
             (8.0, 8.0, -1.0, 0.0, 1.0, 0.5),  # not positive definite
             (8.0, 8.0, 1.0, 1.0 - 1e-7, 1.0, 0.5),  # too thin to bound
             (8.0, 8.0, 1.0, 1.0, 1.0, 0.5)]  # det 0
    rows = np.zeros((9, len(cases)), np.float32)
    rows[[0, 1, 2, 3, 4, 8]] = np.array(cases, np.float32).T
    box = nn(TR.frag_pixel_box_plain(torch.from_numpy(rows)))
    assert box[:, 0].tolist() == [5, 10, 5, 10]
    lo, hi = TR.BOX_EMPTY
    for mode in MODES:
        assert nn(TR.frag_pixel_box_plain(torch.from_numpy(rows), 9.0, mode)
                  )[:, 1].tolist() == [lo, hi, lo, hi]
    for j in (2, 3, 4, 5):
        assert box[:, j].tolist() == [0, 15, 0, 15], j


def test_cull_counts_partition_the_warps(rowtrim_streams):
    """Kept and skipped (warp, fragment) pairs add up to 8 per drawn
    fragment, and the cull skips most of them on the rowtrim stream."""
    frags, start, draw_len = rowtrim_streams[0]
    drawn = int(draw_len.sum())
    kept, skipped = cull_counts(frags, start, draw_len)
    assert kept + skipped == 8 * drawn
    assert 0 < kept < skipped, (kept, skipped)
