"""The torch port's one-level binning (K7 plain + bin_splats) against the
JAX package's ``bin_splats``, on tests/test_expand.py's scenes.

Every FragmentStream field must be equal bit for bit: against
``expand_impl="xla"`` the gaussian ids of the live slots (the XLA route
clamps the padding's ids; the port, like the Pallas route, writes 0),
against ``expand_impl="pallas"`` (its ``_expand_kernel`` in interpret
mode) all of them. The JAX reference is jitted, one compile per shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_core_tpu.ops import binning as JB
from wgpu_3dgs_core_tpu_torch.ops import binning as TB
from wgpu_3dgs_core_tpu_torch.ops import expand as TE

from .test_expand import _random_scene
from .torch_parity import nn, one_torch_thread, tt  # noqa: F401

_jax_bin = jax.jit(JB.bin_splats, static_argnames=(
    "tiles_x", "tiles_y", "max_fragments", "tile_y_offset", "expand_impl"))


@functools.lru_cache(maxsize=None)
def _scene(n, seed):
    return _random_scene(n, seed)


def _both(n, seed, impl="xla", culled=False, **kw):
    xy, extent, depth, mask = _scene(n, seed)
    if culled:
        mask = jnp.zeros_like(mask)
    want = _jax_bin(xy, extent, depth, mask, expand_impl=impl, **kw)
    got = TB.bin_splats(tt(xy), tt(extent), tt(depth), tt(mask), **kw)
    return got, want


def _assert_streams_equal(got, want, all_ids):
    for name in ("tile_id", "num_fragments", "overflow", "tile_start",
                 "tile_end"):
        a, b = nn(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    nf = len(got.gauss_id) if all_ids else int(want.num_fragments)
    np.testing.assert_array_equal(nn(got.gauss_id)[:nf],
                                  np.asarray(want.gauss_id)[:nf])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [37, 1000])
def test_bin_splats_matches_jax(seed, n):
    got, want = _both(n, seed, tiles_x=40, tiles_y=30, max_fragments=65536)
    assert int(got.num_fragments) > 0
    _assert_streams_equal(got, want, all_ids=False)


def test_bin_splats_matches_jax_expand_kernel():
    """Against the JAX Pallas route: every slot, padding included."""
    got, want = _both(1000, 0, impl="pallas", tiles_x=40, tiles_y=30,
                      max_fragments=16384)
    _assert_streams_equal(got, want, all_ids=True)


def test_bin_splats_overflow_parity():
    got, want = _both(500, 7, tiles_x=40, tiles_y=30, max_fragments=4096)
    assert bool(got.overflow)
    _assert_streams_equal(got, want, all_ids=False)


def test_bin_splats_all_culled():
    got, want = _both(64, 3, culled=True, tiles_x=40, tiles_y=30,
                      max_fragments=4096)
    assert int(got.num_fragments) == 0
    _assert_streams_equal(got, want, all_ids=True)


_jax_count = jax.jit(JB.count_fragments, static_argnums=(3, 4))


def test_bin_splats_strip_offset_parity():
    """A strip of 8 tile rows from global row 2, and count_fragments of the
    strip and of the rows from 0, against JAX's."""
    got, want = _both(800, 11, tiles_x=40, tiles_y=8, max_fragments=65536,
                      tile_y_offset=2)
    _assert_streams_equal(got, want, all_ids=False)
    xy, extent, _, mask = _scene(800, 11)
    for off in (0, 2):
        jcount = _jax_count(xy, extent, mask, 40, 8, off)
        count = TB.count_fragments(tt(xy), tt(extent), tt(mask), 40, 8, off)
        assert int(count) == int(jcount) > 0
    assert int(count) == int(got.num_fragments)


def test_bin_splats_any_capacity():
    """K7 takes a capacity that is no multiple of 512 (the JAX package
    then takes its XLA route). The 366 live fragments fit both capacities,
    so the stream is JAX's 65,536-slot stream cut to 1,000 slots."""
    got, want = _both(37, 0, tiles_x=40, tiles_y=30, max_fragments=65536)
    xy, extent, depth, mask = _scene(37, 0)
    cut = TB.bin_splats(tt(xy), tt(extent), tt(depth), tt(mask), 40, 30,
                        1000)
    assert int(cut.num_fragments) == int(want.num_fragments) < 1000
    np.testing.assert_array_equal(nn(cut.tile_id),
                                  np.asarray(want.tile_id)[:1000])
    _assert_streams_equal(cut._replace(tile_id=got.tile_id), want,
                          all_ids=False)


def test_segment_table_and_k7_plain():
    """The one-level table holds the nonzero counts in original order,
    then count-0 rows at offset total; K7's plain version writes tile
    (t_total) and gid (0) past the total, and rejects N >= 2^24."""
    counts = torch.tensor([2, 0, 3, 0, 1], dtype=torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    span_x = torch.tensor([2, 0, 3, 1, 1], dtype=torch.int32)
    x0 = torch.tensor([1, 5, 0, 2, 3], dtype=torch.int32)
    y0 = torch.tensor([0, 1, 2, 0, 1], dtype=torch.int32)
    gid = torch.arange(5, dtype=torch.int32)
    table = TE.build_segment_table(offsets, counts, span_x, x0, y0, gid)
    assert table.ints[TE.TAB_OFF].tolist() == [0, 2, 5, 6, 6]
    assert table.ints[TE.TAB_CNT].tolist() == [2, 3, 1, 0, 0]
    assert table.ints[TE.TAB_GID, :3].tolist() == [0, 2, 4]
    tile, g = TE.expand_fragments(table, torch.tensor(6, dtype=torch.int32),
                                  8, 4, 99)
    assert g.tolist() == [0, 0, 2, 2, 2, 4, 0, 0]
    assert tile.tolist() == [1, 2, 8, 9, 10, 7, 99, 99]
    with pytest.raises(ValueError, match="2\\^24"):
        TE.build_segment_table(*(torch.zeros(1 << 24, dtype=torch.int32),)
                               * 6)
