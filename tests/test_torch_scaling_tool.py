"""The port's scaling tool (``wgpu_3dgs_core_tpu_torch/tools/
scaling_efficiency.py``) on the CPU.

Its route stage at the tool's D = 8 shapes (N_local 512) has the JAX
tool's inputs, drawn here by its lines (``tools/scaling_efficiency.py``),
and gives the JAX ``_route_to_strips``' send buffer and overflow flag bit
for bit. Its ``main`` on the CPU (gloo ranks spawned by
``parallel/launch.py``, one spawn of 1 rank and one of 2, a tiny scene)
prints the JAX tool's keys for D <= 2, with t(1) / t(1) = 1, finite
times and no kernel launched (the plain versions run here). On a CUDA
device without a card it raises. Its arguments and defaults are the JAX
tool's, read from its source with ``ast``.
"""

import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_core_tpu.parallel.sharded import _route_to_strips as jax_route
from wgpu_3dgs_core_tpu_torch.tools import scaling_efficiency as se

from .torch_parity import jax_tool_defaults, nn, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
GAUSSIANS = 4096  # N_local = 512 at D = 8
TINY = ["--gaussians", str(GAUSSIANS), "--width", "96", "--height", "64",
        "--max-fragments", "16384"]


def test_route_stage_matches_jax():
    """The route's draws, capacity and output are the JAX tool's."""
    n_loc = GAUSSIANS // 8
    rng = np.random.default_rng(0)
    packed = jnp.asarray(rng.random((n_loc, 13)), jnp.float32)
    s0 = jnp.asarray(rng.integers(0, 8, n_loc), jnp.int32)
    s1 = jnp.clip(s0 + jnp.asarray(rng.integers(0, 2, n_loc), jnp.int32),
                  0, 7)
    cap = max(128, int(n_loc * 2.0 / 8) // 128 * 128)

    arrays, got_cap = se.route_inputs(GAUSSIANS)
    assert got_cap == cap
    for got, want in zip(arrays, (packed, s0, s1)):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    send, over = se.route([torch.from_numpy(a) for a in arrays], got_cap)
    want_send, want_over = jax_route(packed, s0, s1, 8, cap)
    assert send.shape == (8, cap, 13)
    np.testing.assert_array_equal(nn(send).view(np.uint32),
                                  np.asarray(want_send).view(np.uint32))
    assert bool(over) == bool(want_over)


def test_cpu_run_prints_jax_keys(capsys):
    """Gloo ranks on the CPU for D = 1 and 2: the JAX tool's keys, the
    device, no kernel launched."""
    out = se.main(["--device", "cpu", *TINY, "--max-devices", "2",
                   "--iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    times = ("plain_1dev_ms", "route_build_8dst_ms", "sharded_1dev_ms",
             "sharded_2dev_ms")
    keys = times + ("efficiency_1dev", "efficiency_2dev",
                    "sharding_overhead_1dev")
    assert set(line) == set(keys) | {"device", "backend", "launches"}
    assert line["device"] == "cpu" and line["backend"] == "gloo"
    assert line["efficiency_1dev"] == 1.0
    for k in keys:
        assert math.isfinite(line[k]) and line[k] > 0, k
    assert line["sharding_overhead_1dev"] == pytest.approx(
        line["sharded_1dev_ms"] / line["plain_1dev_ms"])
    assert line["launches"] == {"1": [{}], "2": [{}, {}]}


def test_cuda_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        se.main(["--device", "cuda", *TINY])


def test_cli_is_the_jax_tools():
    """The JAX tool's arguments and defaults, with ``--device`` (cuda) in
    place of its ``--tpu`` and ``--max-devices`` (every device)."""
    want = jax_tool_defaults(ROOT / "tools" / "scaling_efficiency.py")
    got = vars(se.parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got.pop("max_devices") is None
    assert got == want
