"""Expansion, binning, schedule and rasterizer of the torch port against the
JAX package, stage by stage on the same inputs.

Each stage of the port is fed the JAX package's inputs to that stage
(converted), so a last-ulp difference upstream (XLA's and torch's exp,
log and summation orders differ) cannot move a tile edge: the integer
streams must then be equal bit for bit. The JAX Pallas kernels run in
interpret mode on the CPU, as the JAX package's own tests run them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_core_tpu.ops import binning as JB
from wgpu_3dgs_core_tpu.ops import expand as JE
from wgpu_3dgs_core_tpu.render import renderer as JR
from wgpu_3dgs_core_tpu_torch.ops import binning as TB
from wgpu_3dgs_core_tpu_torch.ops import expand as TE
from wgpu_3dgs_core_tpu_torch.render import renderer as TRR

from wgpu_3dgs_core_tpu.ops.projection import project as jax_project
from wgpu_3dgs_core_tpu.render.camera import Camera as JCamera

from .test_rowtrim import H, W, _scene, random_scene
from .torch_parity import K3_ATOL, nn, one_torch_thread, tt  # noqa: F401

TX, TY = JB.num_tiles(W, H)
T_TOTAL = TX * TY
F_CAP = 8192
R_CAP = 8192


@functools.partial(jax.jit, static_argnums=(5, 6))
def _jax_expand_stages(xy, extent, depth, mask, attr_cols, f_cap, r_cap):
    """The JAX package's bin_splats_attrs (Pallas path), keeping every
    stage's inputs and outputs."""
    n = xy.shape[0]
    depth_key = jnp.where(mask, depth, jnp.inf)
    x0, y0, _, _, span_x, span_y, live, ry_ex = JB._exact_bounds(
        xy, extent, attr_cols[2:5].T, attr_cols[8], mask, TX, TY, 0, 9.0,
        True,
    )
    row_counts = jnp.where(live & (span_x > 0), span_y, 0)
    total_rows = jnp.sum(row_counts)
    attr10 = jnp.concatenate([attr_cols, ry_ex[None]], axis=0)
    gid = jnp.arange(n, dtype=jnp.int32)
    tab_t, attr_t = JE.build_tables(row_counts, span_x, x0, y0, gid, attr10,
                                    depth_key)
    rows = JE.expand_rows(tab_t, attr_t, total_rows, r_cap)
    live_r = jnp.arange(r_cap) < jnp.minimum(total_rows, r_cap)
    rows = jnp.where(live_r[None, :], rows, 0.0)
    tx0_r, cnt_r = JB._row_tile_span(
        rows[JE.ROWS_X0], rows[JE.ROWS_ROW], rows[JE.ROWS_SPANX],
        rows[JE.ROWS_RY], *(rows[JE.ROWS_ATTR0 + i] for i in range(5)), 0,
    )
    cnt_r = jnp.where(live_r, cnt_r, 0)
    off_r = jnp.cumsum(cnt_r) - cnt_r
    total = jnp.sum(cnt_r).astype(jnp.int32)
    tab2, attr2 = JE.build_row_tables(
        off_r, cnt_r, tx0_r, rows[JE.ROWS_ROW], rows[JE.ROWS_GID],
        rows[JE.ROWS_ATTR0:JE.ROWS_ATTR0 + 9], live_r,
    )
    tile, gid_f, fetched = JE.expand_fragments_with_attrs(
        tab2, attr2, total, f_cap, TX, T_TOTAL,
    )
    return dict(
        row_counts=row_counts, span_x=span_x, x0=x0, y0=y0, gid=gid,
        attr10=attr10, depth_key=depth_key, total_rows=total_rows,
        rows=rows, live_r=live_r, tx0_r=tx0_r, cnt_r=cnt_r, total=total,
        tile=tile, gid_f=gid_f, fetched=fetched,
    )


@pytest.fixture(scope="module")
def scene():
    spl, attr = _scene()
    return spl, attr


@pytest.fixture(scope="module")
def stages(scene):
    spl, attr = scene
    out = _jax_expand_stages(spl.xy, spl.extent, spl.depth, spl.mask, attr,
                             F_CAP, R_CAP)
    return {k: np.asarray(v) for k, v in out.items()}


def test_k1_plain_matches_jax_expand_rows(stages):
    s = stages
    table = TE.build_tables(
        tt(s["row_counts"]), tt(s["span_x"]), tt(s["x0"]), tt(s["y0"]),
        tt(s["gid"]), tt(s["attr10"]), tt(s["depth_key"]),
    )
    total_rows = tt(s["total_rows"]).to(torch.int32)
    rows = TE.expand_rows_plain(table, total_rows, R_CAP)
    assert nn(TE.expand_rows(table, total_rows, R_CAP).ints).tolist() == (
        nn(rows.ints).tolist())
    live = s["live_r"]
    assert 0 < live.sum() < R_CAP
    j = s["rows"][:, live]
    ints, attrs = nn(rows.ints)[:, live], nn(rows.attrs)[:, live]
    np.testing.assert_array_equal(ints[TE.ROW_X0], j[JE.ROWS_X0])
    np.testing.assert_array_equal(ints[TE.ROW_ROW], j[JE.ROWS_ROW])
    np.testing.assert_array_equal(ints[TE.ROW_SPANX], j[JE.ROWS_SPANX])
    np.testing.assert_array_equal(ints[TE.ROW_GID], j[JE.ROWS_GID])
    np.testing.assert_array_equal(attrs[9], j[JE.ROWS_RY])
    np.testing.assert_array_equal(attrs[:9],
                                  j[JE.ROWS_ATTR0:JE.ROWS_ATTR0 + 9])
    # Slots past the live rows are written as zeros.
    assert not nn(rows.ints)[:, ~live].any()
    assert not nn(rows.attrs)[:, ~live].any()


def test_k2_plain_matches_jax_expand_fragments_with_attrs(stages):
    s = stages
    rows = s["rows"]
    live_r = tt(s["live_r"])
    table = TE.build_row_tables(
        tt(s["cnt_r"]), tt(s["tx0_r"]), tt(rows[JE.ROWS_ROW]),
        tt(rows[JE.ROWS_GID]), tt(rows[JE.ROWS_ATTR0:JE.ROWS_ATTR0 + 9]),
        live_r,
    )
    total = tt(s["total"])
    tile, gid, attrs = TE.expand_fragments_with_attrs_plain(
        table, total, F_CAP, TX, T_TOTAL)
    n_live = int(s["total"])
    assert 0 < n_live < F_CAP
    live = np.arange(F_CAP) < n_live
    np.testing.assert_array_equal(nn(tile)[live], s["tile"][live])
    np.testing.assert_array_equal(nn(gid)[live], s["gid_f"][live])
    np.testing.assert_array_equal(nn(attrs)[:10, live],
                                  s["fetched"][:10, live])
    assert (nn(tile)[~live] == T_TOTAL).all()
    assert not nn(gid)[~live].any() and not nn(attrs)[:, ~live].any()


@pytest.mark.parametrize("max_fragments,max_rows", [
    (8192, None),  # fits
    (4096, 512),  # fragment and row capacities overflow
])
def test_bin_splats_attrs_bit_identical(scene, max_fragments, max_rows):
    spl, attr = scene
    js, ja, _ = jax.jit(
        functools.partial(JB.bin_splats_attrs, tiles_x=TX, tiles_y=TY,
                          max_fragments=max_fragments, max_rows=max_rows)
    )(spl.xy, spl.extent, spl.depth, spl.mask, attr)
    ts, ta, _ = TB.bin_splats_attrs(
        tt(spl.xy), tt(spl.extent), tt(spl.depth), tt(spl.mask), tt(attr),
        TX, TY, max_fragments, max_rows=max_rows,
    )
    assert int(ts.num_fragments) == int(js.num_fragments) > 0
    assert bool(ts.overflow) == bool(js.overflow)
    assert bool(ts.overflow) == ((max_fragments, max_rows) != (8192, None))
    for name in ("tile_id", "tile_start", "tile_end", "gauss_id"):
        np.testing.assert_array_equal(nn(getattr(ts, name)),
                                      nn(getattr(js, name)), err_msg=name)
    # The port returns the tile-local stream of JAX's sorted attributes,
    # and their gid row as int32.
    ja = np.asarray(ja)
    np.testing.assert_array_equal(
        nn(ta), nn(TB.tile_local_stream(tt(ja), ts.tile_id, TX)))
    np.testing.assert_array_equal(nn(ts.gauss_id), ja[9].astype(np.int32))


@functools.partial(jax.jit, static_argnums=(5, 6))
def _jax_bin_rasterize(attr_cols, xy, extent, depth, mask_f, f_cap,
                       pad_slack):
    """The JAX renderer's binning + padded schedule + Pallas forward kernel
    (chunk 128, group 8): (tiles, written, overflow, sorted stream,
    tile_start, tile_end, live_blocks, truncated)."""
    (tiles, written, overflow), res = JR._bin_rasterize_impl(
        attr_cols, xy, extent, depth, mask_f, 0, TX, TY, f_cap, 128,
        (0.1, 0.2, 0.3), 9.0, 0, pad_slack, None,
    )
    mat = res[0]
    tile_sorted = mat[10, :f_cap].astype(jnp.int32)
    ids = jnp.arange(T_TOTAL, dtype=jnp.int32)
    start = jnp.searchsorted(tile_sorted, ids, side="left").astype(jnp.int32)
    end = jnp.searchsorted(tile_sorted, ids, side="right").astype(jnp.int32)
    f_pad_cap = -(-(f_cap + int(T_TOTAL * 128 * pad_slack)) // 1024) * 1024
    sched = JB.pad_schedule(
        JB.FragmentStream(None, tile_sorted, None, None, start, end), 128,
        f_pad_cap,
    )
    return (tiles, written, overflow, mat, start, end, sched.live_blocks[0],
            sched.truncated)


@pytest.mark.parametrize("f_cap,pad_slack", [
    (6656, 1.0),  # fits
    (4096, 0.0),  # fragment capacity and padded schedule both too small
])
def test_rasterize_matches_jax_kernel(scene, f_cap, pad_slack):
    """On the same binned scene as the JAX renderer's forward:

    - the tile-scale schedule (written tiles, truncation) equals JAX's;
    - the port's rasterize_splats builds the sorted stream JAX's kernel
      read, bit for bit, so its K3 (the plain version on the CPU) is fed
      JAX's stream: its tiles equal JAX's forward kernel's on every tile
      that kernel wrote (1e-5), the rest are background, and the overflow
      flags agree.
    """
    spl, attr = scene
    bg = (0.1, 0.2, 0.3)
    tiles, written, overflow, mat, start, end, live_blocks, truncated = (
        np.asarray(x) for x in _jax_bin_rasterize(
            attr, spl.xy, spl.extent, spl.depth,
            spl.mask.astype(jnp.float32), f_cap, pad_slack,
        )
    )
    tile_sorted = mat[10, :f_cap].astype(np.int32)
    assert TB.CHUNK == 128
    sched = TB.pad_schedule(
        TB.FragmentStream(None, tt(tile_sorted), None, None, tt(start),
                          tt(end)),
        TB.padded_capacity(f_cap, T_TOTAL, pad_slack),
    )
    np.testing.assert_array_equal(nn(sched.tile_written), written)
    assert bool(sched.truncated) == bool(truncated)
    assert int(sched.live_blocks) == int(live_blocks)

    # The port's own binning and rasterize_splats on the same splats.
    args = [tt(x) for x in (spl.xy, spl.extent, spl.depth, spl.mask, attr)]
    stream, frags, _ = TB.bin_splats_attrs(*args, TX, TY, f_cap)
    np.testing.assert_array_equal(nn(frags), mat[0:9, :f_cap])
    np.testing.assert_array_equal(nn(stream.gauss_id),
                                  mat[9, :f_cap].astype(np.int32))
    np.testing.assert_array_equal(nn(stream.tile_id), tile_sorted)
    xy, extent, depth, mask, a = args
    mine, mine_overflow = TRR.rasterize_splats(
        xy, depth, a[2:5].T, extent, mask, a[5:8].T, a[8], TX, TY, f_cap,
        bg, pad_slack=pad_slack,
    )
    bg_block = np.array([*bg, 1.0], np.float32)[None, :, None]
    want = np.where(written[:, None, None], tiles, bg_block)
    np.testing.assert_allclose(nn(mine), want, atol=K3_ATOL, rtol=0)
    assert bool(mine_overflow) == bool(overflow)
    assert bool(overflow) == (f_cap < 6516)  # the scene's live fragments
    if bool(overflow):
        # The schedule's capacity cut tiles the stream holds.
        assert (nn(sched.draw_len) < end - start).any()


# A2: the capacity counts' scene, a few thousand gaussians at 320x200.
COUNT_N, COUNT_W, COUNT_H = 3000, 320, 200


@pytest.fixture(scope="module")
def count_scene():
    """The JAX projection of a random scene at COUNT_W x COUNT_H: (xy,
    extent, conic, op_eff (opacity, zero where masked), mask, tiles_x,
    tiles_y) as numpy arrays and ints."""
    cam = JCamera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                          width=COUNT_W, height=COUNT_H, fov_y=0.9)
    means, cov6, _, opac, _ = random_scene(COUNT_N, seed=5)
    spl = jax_project(means, cov6, cam, opacity=opac)
    arrays = [np.asarray(a) for a in (spl.xy, spl.extent, spl.conic,
                                      opac * spl.mask, spl.mask)]
    return (*arrays, *JB.num_tiles(COUNT_W, COUNT_H))


@pytest.mark.parametrize("opacity_cull", [True, False])
@pytest.mark.parametrize("cutoff_sq", [4.0, 9.0])
def test_count_capacities_match_jax_counts(count_scene, opacity_cull,
                                           cutoff_sq):
    """count_capacities against the JAX count_rows and
    count_fragments_exact (max_span_y from a host pass over the JAX
    exact bounds), on the same splats: both counts equal."""
    xy, extent, conic, op_eff, mask, tx, ty = count_scene
    kw = dict(cutoff_sq=cutoff_sq, opacity_cull=opacity_cull)
    bounds = JB._exact_bounds(xy, extent, conic, op_eff, mask, tx, ty, 0,
                              cutoff_sq, opacity_cull)
    span_x, span_y, live = (np.asarray(b) for b in bounds[4:7])
    max_span_y = int(np.where(live & (span_x > 0), span_y, 0).max())
    assert max_span_y > 1
    want_rows = int(JB.count_rows(xy, extent, conic, op_eff, mask, tx, ty,
                                  **kw))
    want_frags = int(JB.count_fragments_exact(
        xy, extent, conic, op_eff, mask, tx, ty, max_span_y=max_span_y,
        **kw))
    rows, frags = TB.count_capacities(
        *(tt(a) for a in (xy, extent, conic, op_eff, mask)), tx, ty, **kw)
    assert (int(rows), int(frags)) == (want_rows, want_frags)
    assert want_frags > want_rows > 0


def test_default_max_fragments_matches_jax():
    """default_max_fragments, avg_overlap included, equals the JAX
    heuristic for small and large n (the 1024 floor, the n * tiles cap)."""
    for n in (0, 1, 3, 100, 2000, 1_000_000):
        for tiles in ((1, 1), (10, 7), (120, 68)):
            assert TB.default_max_fragments(n, *tiles) == (
                JB.default_max_fragments(n, *tiles))
            for overlap in (1.0, 8.0, 20.0):
                assert TB.default_max_fragments(
                    n, *tiles, avg_overlap=overlap) == (
                    JB.default_max_fragments(n, *tiles,
                                             avg_overlap=overlap)), (
                    n, tiles, overlap)
