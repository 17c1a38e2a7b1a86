"""One run of one benchmark cell of wgpu_3dgs_core_tpu_torch.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are read from ``BENCHMARK.json``; each is found by name:
``benchmark/configs/<config>.json``, ``benchmark/traffic/<traffic>.json``
(whose ``loop`` picks one of ``loops.LOOPS``), ``benchmark/limits/<cell>
.json`` (the limit of each number ``correct`` compares) and, for a
per-layer metric, ``benchmark/metrics/<name>.py`` or, failing that, the
file of its name up to the first dot.

A run: set-up (import, kernel build or load, the loop's scene, capacities,
targets and warm-up), the window of ``--seconds``, then the loop's
``after_window``: with ``--trace 1`` a traced block of further
iterations, and for training the checked steps, each from the seed's
draw through the window's own step objects; then the program's state is
freed and the reference checks what the timed path produced.
The last line of standard output is the result; the numbers compared
with their limits are also the last lines of standard error. ``--device
cpu`` runs the plain path at whatever size it is given, for tests.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wgpu_3dgs_core_tpu")


def load_spec(workload: str):
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads(
        (BENCH_DIR / "limits" / f"{workload}.json").read_text())

    def applies(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    layer = [m for m in bench["per_layer"] if applies(m)]
    return dict(cell=cell, config=cfg, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str):
    """The ``read(ctx)`` of a per-layer metric, found by its name."""
    for stem in (name, name.split(".")[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"benchmark_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for per-layer metric {name}")


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def end_to_end(loop, window_s: float, iters: int, failed: int,
               setup_s: float) -> dict:
    """The end-to-end metrics over the whole window."""
    good = iters - failed
    out = {"setup_s": setup_s}
    if loop.kind == "train":
        px = int(loop.cfg["width"]) * int(loop.cfg["height"])
        out["train_mpix_s"] = px * good / window_s / 1e6
    else:
        out["view_fps"] = good / window_s
        out["view_frame_p95_ms"] = p95(loop.frame_ms)
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda"):
    """One run; returns (result dict, stderr lines of the check)."""
    import torch

    from . import loops
    from . import trace as tr
    from .reference import render as rr

    t_start = T_PROCESS
    dev = torch.device(device)
    cfg, traffic = spec["config"], spec["traffic"]
    split = {}
    t0 = time.perf_counter()
    split["import"] = t0 - t_start
    loops.port()
    if dev.type == "cuda":
        from wgpu_3dgs_core_tpu_torch.ops import cuda as port_cuda

        port_cuda.build()
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    split["build_load"] = time.perf_counter() - t0

    loop = loops.LOOPS[traffic["loop"]](cfg, traffic, seed, dev)
    loop.setup()
    split.update(loop.setup_split)
    loop.start_window()
    loops.sync(dev)
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    iters = failed = 0
    starts = []
    while (now := time.perf_counter()) - t_win < seconds:
        loop.iterate(iters)
        iters += 1
        failed += not loop.last_ok
        starts.append(now)
    loops.sync(dev)
    window_s = time.perf_counter() - t_win
    memory_peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                   else 0)

    def traced_block(iterate):
        return tr.traced_block(iterate, int(traffic["trace_iters"]),
                               int(traffic["gap_iters"]), dev)

    traced = loop.after_window(traced_block if trace else None)
    loop.release()

    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)

    t_check = time.perf_counter()
    gaps = loop.check()
    check_s = time.perf_counter() - t_check
    limits = spec["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    correct = (loop.overflowed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": bool(correct), "attempted": iters,
              "failed": failed}
    if trace:
        ctx = layer_context(loop, traced, rr, tr)
        ctx["iter_s"] = window_s / max(iters, 1)
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        # The work the rooflines and MFU counted, a mean per traced
        # iteration, beside the drift record.
        result["counted_work"] = {
            f: sum(getattr(c, f) for c in ctx["work"]) / len(ctx["work"])
            for f in ("visible", "used", "fragments", "blended")}
        device_info["busy_s"] = tr.busy_seconds(traced.device_ops)
        device_info["window_s"] = traced.window_s
        result["breakdown"] = {
            "device_ops": tr.top_device_ops(traced.device_ops),
            "idle_gaps": tr.idle_gaps(traced)}
    else:
        e2e = end_to_end(loop, window_s, iters, failed, setup_s)
        # A metric is its quantity, named up to the first dot, in the
        # cells it lists (``train_mpix_s.host``: ``train_mpix_s``).
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["setup_split_s"] = split
    result["capacities"] = list(loop.capacities)
    result["check_s"] = check_s
    result["drift_fragments"] = loop.drift
    # Iterations started in each whole second of the window: how steady
    # the rate was within the run.
    result["iters_per_s"] = [
        sum(1 for t in starts if k <= t - t_win < k + 1)
        for k in range(int(window_s))]
    result["checks"] = checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    lines.insert(0, "overflowed outside the window "
                    f"{loop.overflowed} limit 0")
    if loop.drift:
        lines.insert(0, "drawn fragments of the first view, before the "
                        "first step, after the window and (traced) after "
                        f"the traced block from the draw: {loop.drift}")
    return result, lines


def layer_context(loop, traced, rr, tr) -> dict:
    """What the per-layer readers read: the trace, the work of each
    traced iteration counted by the reference from the inputs, and (set
    by the caller) ``iter_s``, the measured window's seconds per
    iteration, untraced."""
    inputs = loop.inputs()
    counts = {}
    for v in set(traced.views):
        view = loop.ref_views[v]
        cols, depth, valid = rr.splat_columns(*inputs, view)
        counts[v] = rr.render(cols, depth, valid, view.width, view.height,
                              counts=True)[2]
        del cols, depth, valid
    work = [counts[v] for v in traced.views]
    return dict(kind=loop.kind, trace=traced, work=work,
                iters=traced.iters, window_s=traced.window_s)


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of JAX or of the JAX package are loaded: "
                         + ", ".join(names))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the benchmark) or cpu (tests at toy sizes)")
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    try:
        import torch
    except ImportError as e:
        print(f"no torch: {e}", file=sys.stderr)
        return 2
    if args.device == "cuda":
        chips = int(spec["cell"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count()} available", file=sys.stderr)
            return 2
    try:
        import wgpu_3dgs_core_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    try:
        result, lines = run_cell(spec, args.seed, args.seconds,
                                 bool(args.trace), args.device)
    except ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
