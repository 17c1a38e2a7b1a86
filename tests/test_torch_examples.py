"""The torch port's examples and coverage runner on the CPU.

Each example of ``wgpu_3dgs_core_tpu_torch.examples`` runs with
``--device cpu``, writing into ``tmp_path``; the repo's ``examples/`` and
``coverage/`` stay as they were. The coverage runner
(``wgpu_3dgs_core_tpu_torch/tools/coverage.py``) runs one small test
selection and writes its badge and report into the directory it is
given.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import wgpu_3dgs_core_tpu_torch as T

from .torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _state(*dirs):
    return sorted((str(p), p.stat().st_mtime_ns) for d in dirs
                  for p in (REPO / d).iterdir())


@pytest.fixture
def untouched():
    before = _state("examples", "coverage")
    yield
    assert _state("examples", "coverage") == before


def _run(name, *argv):
    mod = importlib.import_module(f"wgpu_3dgs_core_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu", *map(str, argv)]) == 0


@pytest.mark.parametrize("name", ["read_ply", "read_spz"])
def test_reader_examples(name, untouched, capsys):
    _run(name)
    assert "loaded 3 gaussians" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["write_ply", "write_spz"])
def test_writer_examples(name, untouched, tmp_path, capsys):
    out = tmp_path / f"scene.{name[-3:]}"
    _run(name, out)
    assert str(out) in capsys.readouterr().out
    soa = T.Gaussians.read_from_file(
        out, T.GaussiansSource(name[-3:])).to_soa()
    np.testing.assert_array_equal(soa.pos[:, 0], [-1.0, 0.0, 1.0])
    _run(name)  # no path: a temporary directory
    assert "wrote 3 gaussians" in capsys.readouterr().out


@pytest.mark.parametrize("scene", ["model.ply", "model.spz"])
def test_render_scene_example(scene, untouched, tmp_path):
    out = tmp_path / "render.npy"
    _run("render_scene", REPO / "examples" / scene, out, "--width", 64,
         "--height", 48)
    img = np.load(out)
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()
    assert img.min() < 0.9  # the white background holds coloured splats


def test_fit_scene_example(untouched, capsys):
    _run("fit_scene", "--steps", 3)
    assert "over 3 steps on cpu" in capsys.readouterr().out


def test_coverage_runner_writes_where_told(untouched, tmp_path):
    cmd = [sys.executable, "wgpu_3dgs_core_tpu_torch/tools/coverage.py",
           "--out", str(tmp_path), "--device", "cpu", "--",
           "tests/test_torch_spz.py", "-q", "-p", "no:cacheprovider",
           "-k", "example_spz_bit"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    badge = json.loads((tmp_path / "badge.json").read_text())
    report = json.loads((tmp_path / "report.json").read_text())
    assert badge["label"] == "coverage"
    files = report["files"]
    assert files["wgpu_3dgs_core_tpu_torch/models/spz.py"] > 50
    assert files["wgpu_3dgs_core_tpu_torch/examples/fit_scene.py"] > 90
    assert 0 < report["total_percent"] < 100
