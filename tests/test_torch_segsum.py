"""K5's function (the segment sums per gaussian) on the streams its card
design finds hard, against the JAX package.

``tools/bench_segsum.py::hard_streams`` builds them against the chunk of
slots one block of the CUDA kernel owns (``ops/segreduce.py::
SEGSUM_CHUNK``): a run longer than three chunks, every tile end inside a
run, no drawn slot, every slot drawn, one gaussian owning every slot, live
rows with no drawn slot, drawn keys missing from the gid column. On the
CPU ``segment_sums_sorted`` runs its plain version; it is held to a numpy
float64 sum per key and to JAX ``segment_sums_sorted`` (its Pallas kernel
in interpret mode, the gradients read in key order). K10's levels (K5
stripped level by level, ``ops/variants.py``) are held there to their
float64 numpy definitions. The CUDA kernel runs on the same streams in
``tests/test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_core_tpu.ops import segreduce as JS
from wgpu_3dgs_core_tpu_torch.ops import segreduce as TS
from wgpu_3dgs_core_tpu_torch.ops import variants as KV
from wgpu_3dgs_core_tpu_torch.tools.bench_segsum import (
    HARD_STREAMS,
    hard_streams,
)

from .torch_parity import nn, one_torch_thread  # noqa: F401

# Normalized: max |got - want| / max |want| per gradient row. The plain
# version sums in float64 and rounds once; JAX sums exact bf16 splits with
# float32 accumulation (the card's bar for K5, chip_smoke.py K5_TOL).
PLAIN_TOL = 1e-6
JAX_TOL = 1e-5
F32_EXACT = 2.0 ** 24  # JAX's sentinel past every gid


@pytest.fixture(scope="module")
def streams():
    """{name: (torch stream, the same as numpy)}."""
    return {name: (st, tuple(nn(t) for t in st[:4]) + st[4:])
            for name, st in hard_streams().items()}


def _numpy_sums(keys, perm, grad, gid_col, n):
    """float64 sum of the gradient rows of the slots keyed by each row's
    gid; zeros for sentinel rows and gids with no slot."""
    sums = np.zeros((n + 1, TS.GRAD_ROWS))
    drawn = keys < n
    np.add.at(sums, keys[drawn], grad[:, perm[drawn]].T.astype(np.float64))
    return sums[gid_col].T


def _normalized(got, want):
    err = np.abs(got - want).max(axis=1)
    scale = np.abs(want).max(axis=1)
    return float(np.where(scale > 0, err / np.where(scale > 0, scale, 1),
                          err).max())


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_segsum(grad_sorted, keys_f, gid_mono, d):
    dgs = JS.split_grad_rows([grad_sorted[i] for i in range(TS.GRAD_ROWS)])
    return JS.segment_sums_sorted(dgs, keys_f, gid_mono, jnp.int32(d))


def _jax_sums(keys, perm, grad, gid_col, n):
    """JAX segment_sums_sorted on the same stream: the gradients in key
    order, f32 keys, the gid column with its sentinel and padding."""
    rows = gid_col.shape[0]
    k = JS.SEG_BLOCK
    gid_mono = np.full(-(-rows // k) * k, F32_EXACT, np.float32)
    gid_mono[:rows] = np.where(gid_col < n, gid_col, F32_EXACT)
    d = int((keys < n).sum())
    comp = np.asarray(_jax_segsum(jnp.asarray(grad[:, perm]),
                                  jnp.asarray(keys.astype(np.float32)),
                                  jnp.asarray(gid_mono), d))
    return comp.transpose(1, 0, 2).reshape(comp.shape[1], -1)[
        :TS.GRAD_ROWS, :rows]


def test_hard_streams_have_their_shape(streams):
    """Each stream is what its name says, relative to K5's chunk (the
    tile is half a chunk); all share one shape, so JAX compiles once."""
    chunk, tile = TS.SEGSUM_CHUNK, TS.SEGSUM_CHUNK // 2
    assert set(streams) == set(HARD_STREAMS)
    shapes = {(st[0].shape, st[3].shape) for _, st in streams.values()}
    assert len(shapes) == 1
    for name, (_, (keys, perm, grad, gid_col, n)) in streams.items():
        f = keys.shape[0]
        assert (np.diff(keys) >= 0).all()
        assert np.array_equal(np.sort(perm), np.arange(f))
        d = int((keys < n).sum())
        drawn = keys[:d]
        runs = np.diff(np.flatnonzero(np.diff(
            np.concatenate([[-1], drawn, [n]])) != 0))
        live = gid_col[gid_col < n]
        inside = [keys[b - 1] == keys[b] for b in range(tile, d, tile)]
        if name == "long_run":
            assert runs.max() > 3 * chunk
        elif name == "straddling":
            assert inside and all(inside)
        elif name == "empty":
            assert d == 0 and live.size > 0
        elif name == "all_drawn":
            assert d == f and not any(inside)
        elif name == "one_gaussian":
            assert d == f and runs.size == 1
        elif name == "live_no_slot":
            assert np.setdiff1d(live, drawn).size > 0
        elif name == "missing_key":
            assert np.setdiff1d(drawn, live).size > 0


@pytest.mark.parametrize("name", HARD_STREAMS)
def test_k5_plain_matches_numpy_and_jax(streams, name):
    """K5 on the CPU (its plain version) against a float64 sum per key and
    against JAX segment_sums_sorted; rows no run reaches are exact
    zeros."""
    stream, (keys, perm, grad, gid_col, n) = streams[name]
    mine = nn(TS.segment_sums_sorted(*stream))
    want = _numpy_sums(keys, perm, grad, gid_col, n)
    assert _normalized(mine, want) <= PLAIN_TOL
    reached = np.isin(gid_col, keys[keys < n])
    assert not mine[:, ~reached].any()
    jax_sums = _jax_sums(keys, perm, grad, gid_col, n)
    assert _normalized(jax_sums, want) <= JAX_TOL
    assert _normalized(mine, jax_sums) <= JAX_TOL


@pytest.mark.parametrize("level", KV.SEGSUM_LEVELS)
def test_k10_levels_plain_match_numpy(streams, level):
    """Each K10 level by its definition, on the runs across tile ends and
    the keys missing from the gid column: s0_prep leaves zeros in the
    output, the gradients slot-major in grad_t and each live gid's first
    row in row_of; s1_scan sums the key-ordered copy in key order, and
    s2_gather and s2_nostage sum through the permutation, each within the
    float64 sum per key."""
    for name in ("straddling", "missing_key"):
        stream, (keys, perm, grad, gid_col, n) = streams[name]
        t_keys, t_perm, t_grad, t_gid = stream[:4]
        operand = KV.level_operand(level, t_grad, t_perm)
        f = keys.shape[0]
        grad_t = torch.full((f, TS.GRAD_ROWS), -1.0)
        row_of = torch.full((n,), -1, dtype=torch.int32)
        got = nn(KV.segment_sums_level(level, t_keys, t_perm, operand, t_gid,
                                       n, scratch=(grad_t, row_of)))
        live = gid_col < n
        first = np.flatnonzero(live & np.concatenate(
            [[True], gid_col[1:] != gid_col[:-1]]))
        want_row_of = np.full(n, -1)
        want_row_of[gid_col[first]] = first
        assert np.array_equal(nn(row_of), want_row_of), (name, level)
        staged = nn(grad_t)
        if level == "s2_nostage":
            assert (staged == -1.0).all()  # no staging copy
        else:
            assert np.array_equal(staged, nn(operand).T), (name, level)
        if level == "s0_prep":
            assert not got.any()
            continue
        order = np.arange(f) if level == "s1_scan" else perm
        want = _numpy_sums(keys, order, nn(operand), gid_col, n)
        assert _normalized(got, want) <= PLAIN_TOL, (name, level)
