"""BENCHMARK.json against the contract, and every piece found by name."""

import json
import re

import pytest

from benchmark import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for text in (x for c in BENCH["configs"] for x in (c["source"], c["why"])):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metrics_fit_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    spec = run.load_spec(cell)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(run.metric_reader(m["name"]))
    assert spec["traffic"]["loop"] in ("train", "view")
    cfg = spec["config"]
    conf = {c["name"]: c for c in BENCH["configs"]}[spec["cell"]["config"]]
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert set(spec["limits"]) == ({"loss_gap", "grad_gap", "update_gap",
                                    "image_gap"}
                                   if spec["traffic"]["loop"] == "train"
                                   else {"image_gap", "trans_gap"})


def test_every_config_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_stated_cameras_are_the_traffic_ones():
    """A configuration that states its cameras (to list them as reduced)
    states those that the train traffic runs."""
    t = json.loads((run.BENCH_DIR / "traffic" / "train.json").read_text())
    for c in BENCH["configs"]:
        cfg = json.loads((run.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg)
        cams = cfg.get("cameras")
        if cams is None:
            continue
        assert cams == {"train_views": t["views"],
                        "azimuth_arc_deg": 2 * t["azimuth_deg"],
                        "elevation_arc_deg": 2 * t["elevation_deg"],
                        "radius": t["radius"], "fov_y": t["fov_y"]}
