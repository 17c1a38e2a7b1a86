"""A toy run of each mix on the CPU through the port's plain path, and
the command's refusals."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import toy_spec


@pytest.mark.parametrize("cell", ["synth1m-train", "bicycle6m-view"])
def test_toy_run_is_correct(cell):
    spec = toy_spec(cell)
    result, lines = run.run_cell(spec, 2 ** 31 + 12345, 0.3, False, "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in spec["end_to_end"]}
    assert set(result["metrics"]) == names
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert lines[-1].startswith("check ")
    assert not run.forbidden_modules()


def test_toy_traced_run_keeps_its_keys():
    spec = toy_spec("bicycle6m-view", gaussians=800, width=48, height=32)
    spec["traffic"] = dict(spec["traffic"], trace_iters=2, gap_iters=1)
    result, _ = run.run_cell(spec, 7, 0.1, True, "cpu")
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # The CPU trace holds no device operation: every reader finds nothing.
    assert result["metrics"] == {}


def test_toy_traced_train_run_traces_from_the_draw():
    """The traced block of a training cell runs from the seed's draw,
    whose work the rooflines count; the checked steps follow it, again
    from the draw."""
    spec = toy_spec("synth1m-train", gaussians=800, width=48, height=32)
    spec["traffic"] = dict(spec["traffic"], trace_iters=2, gap_iters=1)
    result, lines = run.run_cell(spec, 2 ** 31 + 9, 0.1, True, "cpu")
    assert result["correct"], result["checks"]
    assert len(result["drift_fragments"]) == 3
    assert set(result["counted_work"]) == {"visible", "used", "fragments",
                                           "blended"}
    assert list(result)[-1] == "checks"


def test_same_seed_same_inputs():
    from benchmark import scene as sc
    cfg = toy_spec("synth1m-train")["config"]
    a = sc.draw_scene(cfg, 2 ** 31 + 5, "cpu")
    b = sc.draw_scene(cfg, 2 ** 31 + 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "bicycle6m-view",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_command_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark."""
    import shutil
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "bicycle6m-view",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())


@pytest.mark.cuda
def test_toy_run_on_the_card(card):
    for cell in ("synth1m-train", "bicycle6m-view"):
        result, _ = run.run_cell(toy_spec(cell, 20000, 320, 192), 99, 0.5,
                                 True, "cuda")
        assert result["correct"], result["checks"]
        assert result["device"]["busy_s"] > 0
