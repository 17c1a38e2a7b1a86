"""The torch port's utils against the JAX package's: sharded checkpoints
(``utils/checkpoint.py``) written by one package and read by the other bit
for bit, the tensor adapter for extras, and the profiling helpers
(``utils/profiling.py``) on the CPU: a named scope in an exported trace,
``timed`` and ``block_and_time``, and how ``device_calls`` splits a
profiled session into calls and re-runs a session that lost operations.
"""

import glob
import types
import json
import os

import numpy as np
import torch

import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu.utils import checkpoint as jck
from wgpu_3dgs_core_tpu_torch.utils import checkpoint as tck
from wgpu_3dgs_core_tpu_torch.utils import profiling as tpf

from .common import gaussian_soa_with_seeds
from .torch_parity import one_torch_thread  # noqa: F401

FIELDS = ("rot", "pos", "color", "sh", "scale")


def _port_soa(soa):
    return T.GaussianSoA(**{f: getattr(soa, f) for f in FIELDS})


def _same_soa(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_port_checkpoint_loads_in_jax(tmp_path):
    """Saved by the port, with torch tensors as extras (an optimizer's
    moments, gaussians along dim 0): the JAX package reads the same scene
    and extras bit for bit, whole and resharded."""
    soa = _port_soa(gaussian_soa_with_seeds(list(range(11))))
    moments = {"exp_avg.means": torch.randn(11, 3),
               "exp_avg_sq.sh": torch.rand(11, 15, 3)}
    tck.save_sharded(str(tmp_path), soa, n_shards=4, extra=moments)
    assert jck.load_manifest(str(tmp_path)) == tck.load_manifest(
        str(tmp_path))
    back, extras = jck.load_sharded(str(tmp_path))
    _same_soa(back, soa)
    assert sorted(extras) == sorted(moments)
    for k, v in moments.items():
        np.testing.assert_array_equal(extras[k], v.numpy())
    parts = [jck.load_sharded(str(tmp_path), shard=s, n_shards=3)[0]
             for s in range(3)]
    np.testing.assert_array_equal(np.concatenate([p.pos for p in parts]),
                                  soa.pos)


def test_jax_checkpoint_loads_in_port(tmp_path):
    """Saved by the JAX package: the port reads the scene bit for bit, and
    the extras back as tensors on the device asked for."""
    soa = gaussian_soa_with_seeds(list(range(9)))
    extra = {"m": np.arange(27, dtype=np.float32).reshape(9, 3)}
    jck.save_sharded(str(tmp_path), soa, n_shards=2, extra=extra)
    back, extras = tck.load_sharded(str(tmp_path))
    assert isinstance(back, T.GaussianSoA)
    _same_soa(back, soa)
    tensors = tck.extra_tensors(extras, device="cpu")
    assert tensors["m"].device.type == "cpu"
    np.testing.assert_array_equal(tensors["m"].numpy(), extra["m"])
    part, part_extras = tck.load_sharded(str(tmp_path), shard=1, n_shards=2)
    np.testing.assert_array_equal(part.pos, soa.pos[4:])
    np.testing.assert_array_equal(part_extras["m"], extra["m"][4:])


def test_named_scope_shows_in_the_trace(tmp_path):
    @tpf.annotate("gs_double")
    def double(x):
        return x * 2

    with tpf.trace(str(tmp_path)):
        with tpf.named_scope("gs_outer"):
            out = double(torch.ones(4))
    assert float(out.sum()) == 8.0
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gs_outer", "gs_double"} <= names


def test_timed_and_block_and_time_fill_their_results():
    results = {}
    with tpf.timed("block", results):
        torch.ones(64).sum()
    assert results["block"] >= 0.0
    calls = []

    def fn(x):
        calls.append(1)
        return (x + 1, {"n": x})

    sec = tpf.block_and_time("add", fn, torch.ones(8), iters=3, warmup=2)
    assert sec > 0.0 and len(calls) == 5
    assert tpf.device_name(torch.ones(1).device) == "cpu"


def _op(name):
    return types.SimpleNamespace(name=name)


def test_device_calls_keeps_whole_calls_and_re_runs_short_sessions(
        monkeypatch):
    m, k = _op(tpf.MARKER), _op("kernel")
    # Two lead-in markers kept, then 3 calls of two operations each, the
    # second call missing one: it is left out.
    ops = [m, m, m, k, k, m, k, m, k, k, m]
    calls = tpf.split_calls(ops)
    assert [len(c) for c in calls] == [2, 1, 2]
    assert [len(c) for c in tpf.modal_calls(calls)] == [2, 2]
    assert tpf.split_calls([]) == [] and tpf.modal_calls([]) == []
    # A session that keeps 2 of 3 calls whole is made again; the next,
    # whole, is what device_calls gives.
    sessions = iter([calls, [[k, k]] * 3])
    monkeypatch.setattr(tpf, "_profiled_session",
                        lambda fn, args, kwargs, iters: next(sessions))
    before = tpf.PROFILER_STATS["short sessions"]
    assert len(tpf.device_calls(lambda: None, iters=3)) == 3
    assert tpf.PROFILER_STATS["short sessions"] == before + 1
    # Sessions that never keep half the calls whole raise.
    monkeypatch.setattr(tpf, "_profiled_session",
                        lambda fn, args, kwargs, iters: [])
    try:
        tpf.device_calls(lambda: None, iters=3)
    except RuntimeError as e:
        assert "0 of 3 calls" in str(e)
    else:
        raise AssertionError("device_calls did not raise")
