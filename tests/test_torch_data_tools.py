"""The port's four synthetic measurement tools
(``wgpu_3dgs_core_tpu_torch/tools/bench_sort_shapes.py``,
``bench_irregular_ops.py``, ``bench_reorder.py``, ``bench_reorder2.py``)
on the CPU, at a small size (about 4,096 fragments, 1,000 gaussians).

Each tool's draws equal the JAX tool's (``tools/<name>.py``), drawn here
by its own lines, and each stage's output equals the JAX expression of
the same line on them (jnp and ``lax``, no Pallas): sorts, permutations,
gathers, unique scatters, ``cummax``, ``searchsorted``, ``argsort`` and
the block gather bit for bit, unstable sorts by their keys and their
sorted (key, payload) rows, the sums (``index_add_``,
``segment_reduce``, ``cumsum``) within 1e-5 of the largest |value|
(``torch_parity.assert_same_stage``). Every stage's output is a fresh
contiguous tensor, no view of an input: a view would time nothing on the
card. Each tool's arguments and defaults are the JAX tool's, read from
its source with ``ast``, and its ``main`` raises on the CPU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wgpu_3dgs_core_tpu_torch.tools import (
    bench_irregular_ops,
    bench_reorder,
    bench_reorder2,
    bench_sort_shapes,
)

from .torch_parity import (  # noqa: F401
    assert_same_stage,
    jax_tool_defaults,
    one_torch_thread,
)

ROOT = Path(__file__).resolve().parents[1]
# Small sizes: the sort cases' lengths (forward, backward, tight, table),
# fragments F, gaussians N, tiles T and the block length K.
SORT_SIZES = (4096, 4500, 4200, 1000)
F, N, T, K = 4096, 1000, 64, 128


def jax_sort_shapes():
    """tools/bench_sort_shapes.py's draws and cases A-I, each case's
    output as (keys..., payload rows)."""
    f_fwd, f_bwd, f_tight, n = SORT_SIZES
    rng = np.random.default_rng(0)

    def data(f, n_pay):
        tile = jnp.asarray(rng.integers(0, 8161, f), jnp.int32)
        depth = jnp.asarray(rng.random(f), jnp.float32)
        pays = [jnp.asarray(rng.random(f), jnp.float32) for _ in range(n_pay)]
        return tile, depth, pays

    tile, depth, pays = data(f_fwd, 10)
    gid_b, _, pays_b = data(f_bwd, 9)
    gid_t, _, pays_t = data(f_tight, 9)
    flagn = jnp.asarray(rng.integers(0, 2, n), jnp.int32)
    depthn = jnp.asarray(rng.random(n), jnp.float32)
    paysn = [jnp.asarray(rng.random(n), jnp.float32) for _ in range(24)]
    draws = dict(tile=tile, depth=depth, pays=jnp.stack(pays), gid_b=gid_b,
                 pays_b=jnp.stack(pays_b), gid_t=gid_t,
                 pays_t=jnp.stack(pays_t), flag=flagn, depth_n=depthn,
                 pays_n=jnp.stack(paysn))

    def sort(num_keys, stable, *cols):
        out = jax.lax.sort(cols, num_keys=num_keys, is_stable=stable)
        return tuple(out[:num_keys]) + (jnp.stack(out[num_keys:]),)

    stages = {
        "A fwd: stable 2key(i32,f32)+10pay @3.28M":
            sort(2, True, tile, depth, *pays),
        "B fwd: stable 1key+10pay @3.28M": sort(1, True, tile, *pays),
        "C fwd: unstable 1key+10pay @3.28M": sort(1, False, tile, *pays),
        "D fwd: stable 1key+4pay @3.28M": sort(1, True, tile, *pays[:4]),
        "E fwd: stable 1key+1pay @3.28M": sort(1, True, tile, pays[0]),
        "F bwd: unstable 1key+9pay @4.32M": sort(1, False, gid_b, *pays_b),
        "G bwd: unstable 1key+9pay @3.93M": sort(1, False, gid_t, *pays_t),
        "H tab: stable 1key+25pay @1M (current)":
            sort(1, True, flagn, depthn, *paysn),
        "I tab: stable 2key(i32,f32)+24pay @1M":
            sort(2, True, flagn, depthn, *paysn),
    }
    return draws, stages


def jax_irregular_ops():
    """tools/bench_irregular_ops.py's draws and its eleven ops."""
    f, n, t = F, N, T
    rng = np.random.default_rng(0)
    tile = jnp.asarray(np.sort(rng.integers(0, t, f)).astype(np.int32))
    gid = jnp.asarray(rng.integers(0, n, f).astype(np.int32))
    perm = jnp.asarray(rng.permutation(f).astype(np.int32))
    attr = jnp.asarray(rng.random((n, 9)).astype(np.float32))
    tstart = jnp.asarray(np.arange(t, dtype=np.int32))
    keys_u = jnp.asarray(rng.integers(0, t, f).astype(np.int32))
    drows = jnp.asarray(rng.random((f, 9)).astype(np.float32))
    wide = jnp.asarray(rng.random((f, 16)).astype(np.float32))
    draws = dict(tile=tile, gid=gid, perm=perm, attr=attr, tstart=tstart,
                 keys_u=keys_u, drows=drows, wide=wide)
    stages = {
        "sort2": tuple(jax.lax.sort((keys_u, gid), num_keys=1,
                                    is_stable=True)),
        "sort1": jax.lax.sort((keys_u,), num_keys=1, is_stable=True)[0],
        "scatter": jnp.zeros(f, jnp.int32).at[perm].set(
            jnp.arange(f, dtype=jnp.int32), unique_indices=True),
        "gather_t": tstart[tile],
        "rowgather": attr[gid].T,
        "scat_add9": jnp.zeros((n, 9), jnp.float32).at[gid].add(drows),
        "scat_set16": jnp.zeros((f, 16), jnp.float32).at[perm].set(
            wide, unique_indices=True).T,
        "rowgath16": wide[perm],
        "gather_f": gid[perm],
        "scan_max": jax.lax.associative_scan(jnp.maximum, gid),
        "ss2": (jnp.searchsorted(tile, tstart, side="left"),
                jnp.searchsorted(tile, tstart, side="right")),
    }
    return draws, stages


def jax_reorder():
    """tools/bench_reorder.py's draws and stages."""
    f, n = F, N
    rng = np.random.default_rng(0)
    key = jnp.asarray(rng.integers(0, 8160, f, dtype=np.int32))
    depth = jnp.asarray(rng.random(f, dtype=np.float32))
    gid = jnp.asarray(rng.integers(0, n, f, dtype=np.int32))
    table = jnp.asarray(rng.random((n, 16), dtype=np.float32))
    cols = [jnp.asarray(rng.random(f, dtype=np.float32)) for _ in range(10)]
    rows9 = jnp.asarray(rng.random((16, f), dtype=np.float32))
    draws = dict(key=key, depth=depth, gid=gid, table=table,
                 cols=jnp.stack(cols), rows9=rows9)
    stages = {}
    for m in (1, 3, 6, 10):
        out = jax.lax.sort((key, depth) + tuple(cols[:m]), num_keys=2,
                           is_stable=True)
        stages[f"sort2 + {m} f32 payloads"] = (out[0], out[1],
                                               jnp.stack(out[2:]))
    stages.update({
        "rowgather [F,9]": table[gid, :9],
        "rowgather [F,9] -> [9,F]": table[gid, :9].T,
        "rowgather [F,16] -> [16,F]": table[gid].T,
        "int gather 1 col": depth[gid],
        "scatter-add9 [F]->[N,9]": jnp.zeros((n, 9), jnp.float32).at[
            gid].add(rows9[:9].T),
    })
    return draws, stages


def jax_reorder2():
    """tools/bench_reorder2.py's draws and stages."""
    f, n, k = F, N, K
    b = f // k
    rng = np.random.default_rng(0)
    rows16 = jnp.asarray(rng.random((16, f), dtype=np.float32))
    rows9f = jnp.asarray(rng.random((f, 9), dtype=np.float32))
    src_base = jnp.asarray(np.sort(rng.integers(0, f - k, b)).astype(
        np.int32))
    perm = jnp.asarray(rng.permutation(f).astype(np.int32))
    gid_sorted = jnp.asarray(np.sort(rng.integers(0, n, f)).astype(np.int32))
    depth = jnp.asarray(rng.random(n, dtype=np.float32))
    draws = dict(rows16=rows16, rows9f=rows9f, src_base=src_base, perm=perm,
                 gid_sorted=gid_sorted, depth=depth)
    stages = {
        "blockgather [B,16,K] slices": jax.vmap(
            lambda s: jax.lax.dynamic_slice(rows16, (0, s), (16, k)))(
                src_base),
        "unique perm-scatter set9": jnp.zeros((f, 9), jnp.float32).at[
            perm].set(rows9f, unique_indices=True, mode="drop"),
        "segment_sum9 (sorted ids)": jax.ops.segment_sum(
            rows9f, gid_sorted, num_segments=n, indices_are_sorted=True),
        "argsort N=1M": jnp.argsort(depth, stable=True),
        "cumsum [F,9]": jnp.cumsum(rows9f, axis=0),
    }
    return draws, stages


# Each tool: its module, its draws at the small size, its stages on the
# tensors of its inputs, and the JAX tool's draws and stages.
TOOLS = {
    "bench_sort_shapes": (
        bench_sort_shapes, lambda: bench_sort_shapes.draw(*SORT_SIZES),
        bench_sort_shapes.stages, jax_sort_shapes),
    "bench_irregular_ops": (
        bench_irregular_ops, lambda: bench_irregular_ops.draw(F, N, T),
        bench_irregular_ops.stages, jax_irregular_ops),
    "bench_reorder": (
        bench_reorder, lambda: bench_reorder.draw(F, N),
        bench_reorder.stages, jax_reorder),
    "bench_reorder2": (
        bench_reorder2, lambda: bench_reorder2.draw(F, N, K),
        lambda x: bench_reorder2.stages(x, K), jax_reorder2),
}


def _port(tool):
    module, draw, stages, _ = TOOLS[tool]
    arrays = draw()
    x = module.inputs(arrays, "cpu")
    return arrays, x, stages(x)


@pytest.mark.parametrize("tool", TOOLS)
def test_stages_match_jax(tool):
    """The draws equal the JAX tool's bit for bit, and every stage its
    JAX expression on them."""
    arrays, _, stages = _port(tool)
    jax_draws, jax_stages = TOOLS[tool][3]()
    assert set(arrays) == set(jax_draws)
    for name, a in arrays.items():
        want = np.asarray(jax_draws[name])
        assert a.dtype == want.dtype and a.shape == want.shape, name
        np.testing.assert_array_equal(a, want, err_msg=name)
    assert list(stages) == list(jax_stages)
    for name, fn in stages.items():
        assert_same_stage(fn(), jax_stages[name], name)


@pytest.mark.parametrize("tool", TOOLS)
def test_stage_outputs_are_fresh(tool):
    """Each stage writes its output: contiguous tensors that are no view
    and share no storage with an input (a view would time nothing)."""
    _, x, stages = _port(tool)
    held = {t.untyped_storage().data_ptr() for t in x.values()}
    for name, fn in stages.items():
        out = fn()
        for t in out if isinstance(out, tuple) else (out,):
            assert t.is_contiguous() and t._base is None, name
            assert t.untyped_storage().data_ptr() not in held, name


@pytest.mark.parametrize("tool", TOOLS)
def test_cli_is_the_jax_tools(tool):
    """The arguments, their defaults and the sizes are the JAX tool's,
    plus ``--device`` (default cuda); ``main`` raises on the CPU before
    it draws anything."""
    module = TOOLS[tool][0]
    want = jax_tool_defaults(ROOT / "tools" / f"{tool}.py")
    got = vars(module.parser().parse_args([]))
    assert got.pop("device") == "cuda"
    consts = {k: v for k, v in want.items() if k.isupper()}
    assert got == {k: v for k, v in want.items() if k not in consts}
    assert {k: getattr(module, k) for k in consts} == consts
    with pytest.raises(ValueError, match="CUDA card"):
        module.main(["--device", "cpu"])
