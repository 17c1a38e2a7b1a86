"""Helpers of the torch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and fed to the JAX package and to
its torch port; results are compared as numpy arrays on the CPU.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLE_PLY = Path(__file__).resolve().parents[1] / "examples" / "model.ply"

# Parity bars (tests/test_render.py sets the image ones for the JAX suite).
MATH_TOL = dict(atol=1e-6, rtol=1e-6)  # device math, f32 elementwise
IMAGE_ATOL = 3e-5  # tiled images: f32 blend order differs per renderer
CHAIN_ATOL = 1e-4  # alpha-0.99 chains: the JAX kernel's bf16-split cumsum
K3_ATOL = 1e-5  # K3 plain vs the JAX kernel on the same sorted stream


def tt(x, dtype=None) -> torch.Tensor:
    """numpy or JAX array -> CPU tensor with the same values."""
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def nn(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under several xdist workers on a few cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_scene(n, seed):
    """The scene of tests/test_render.py::_random_scene, as numpy:
    (means, quats, scales, color, opacity, sh)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats = quats / np.linalg.norm(quats, axis=1, keepdims=True)
    scales = (0.05 + 0.2 * rng.random((n, 3))).astype(np.float32)
    color = rng.random((n, 3)).astype(np.float32)
    opac = (0.3 + 0.6 * rng.random(n)).astype(np.float32)
    sh = (0.2 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    return means, quats, scales, color, opac, sh


# The measurement tools' stages (wgpu_3dgs_core_tpu_torch/tools/bench_*.py):
# those whose sums a correct run may add in another order, within SUM_TOL
# of the largest |value|; an unstable sort's ("unstable" in its label) may
# order equal keys otherwise; every other stage's output is bit for bit.
SUMMED_STAGES = ("scat_add9", "scatter-add9 [F]->[N,9]",
                 "segment_sum9 (sorted ids)", "cumsum [F,9]")
SUM_TOL = 1e-5


def stage_kind(name: str) -> str:
    if "unstable" in name:
        return "unordered"
    return "summed" if name in SUMMED_STAGES else "exact"


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_same_stage(got, want, name: str) -> None:
    """A tool stage's output (a tensor or tuple of them) against another's
    of the same structure (tensors or JAX arrays), by ``stage_kind``; an
    unordered sort's output is (keys, payload rows [m, F])."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), name
    got, want = [nn(g) for g in got], [nn(w) for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
    kind = stage_kind(name)
    if kind == "summed":
        for g, w in zip(got, want):
            scale = max(float(np.max(np.abs(w))), 1e-30)
            assert float(np.max(np.abs(g - w))) <= SUM_TOL * scale, name
        return
    if kind == "unordered":
        (gk, gp), (wk, wp) = got, want
        np.testing.assert_array_equal(gk, wk, err_msg=name)
        rows = []
        for k, p in ((gk, gp), (wk, wp)):
            r = np.column_stack([k.astype(np.int64)]
                                + [_bits(c).astype(np.int64) for c in p])
            rows.append(r[np.lexsort(r.T[::-1])])
        np.testing.assert_array_equal(rows[0], rows[1], err_msg=name)
        return
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            assert g.dtype == w.dtype, (name, i)
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{name}[{i}]")
        else:  # integer values (an argsort: int64 here, int32 in JAX)
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64),
                                          err_msg=f"{name}[{i}]")


def jax_tool_defaults(path: Path) -> dict:
    """A JAX tool's argparse defaults and upper-case module constants,
    read from its source with ``ast`` (importing it would set JAX's
    compilation cache), and each ``run`` function's keyword defaults."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.isupper()):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            for kw in node.keywords:
                if kw.arg == "default":
                    name = node.args[0].value.lstrip("-").replace("-", "_")
                    out[name] = ast.literal_eval(kw.value)
        elif isinstance(node, ast.FunctionDef) and node.name == "run":
            args = node.args.args[-len(node.args.defaults):]
            for a, d in zip(args, node.args.defaults):
                out[a.arg] = ast.literal_eval(d)
    return out
