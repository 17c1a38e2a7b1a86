"""The metric arithmetic on made-up numbers."""

import math

import pytest

from benchmark import roofline as rl
from benchmark import run
from benchmark import trace as tr
from benchmark.reference.render import Counts


def test_busy_union_and_idle_share():
    ops = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 32, 35)]
    assert tr.busy_seconds(ops) == pytest.approx(30e-6)
    t = tr.Trace(device_ops=ops, host_ops=[], iters=2, window_s=60e-6)
    # 15 us busy a step in a window of 40 us a step.
    idle = run.metric_reader("device_idle.train")({"trace": t,
                                                   "iter_s": 40e-6})
    assert idle == pytest.approx(62.5)
    assert run.metric_reader("ops_per_step.train")({"trace": t}) == 2.0


def test_glue_leaves_out_hand_kernels():
    ops = [("void rasterize_fwd_kernel<6>", 0, 100),
           ("void at::native::elementwise_kernel", 100, 400),
           ("Memcpy HtoD", 400, 450)]
    t = tr.Trace(device_ops=ops, host_ops=[], iters=1, window_s=1.0)
    assert run.metric_reader("torch_glue_ms.view")({"trace": t}) == \
        pytest.approx(0.35)


def test_p95_nearest_rank():
    assert run.p95(list(range(1, 101))) == 95
    assert run.p95([3.0]) == 3.0
    assert run.p95(list(range(1, 21))) == 19


def test_mpix_and_fps_over_the_window():
    class L:
        kind = "train"
        cfg = {"width": 1920, "height": 1080}
    m = run.end_to_end(L(), window_s=2.0, iters=50, failed=2, setup_s=9.0)
    assert m["train_mpix_s"] == pytest.approx(1920 * 1080 * 48 / 2.0 / 1e6)
    assert m["setup_s"] == 9.0

    class V:
        kind = "view"
        frame_ms = [10.0] * 19 + [30.0]
    m = run.end_to_end(V(), window_s=0.5, iters=20, failed=0, setup_s=1.0)
    assert m["view_fps"] == 40.0 and m["view_frame_p95_ms"] == 10.0


def test_rooflines_from_counts():
    c = Counts(gaussians=1000, visible=900, used=800, fragments=2000,
               blended=50000, pixels=10000)
    f, b = rl.k3(c)
    assert f == 22 * 50000
    assert b == 36 * 800 + 4 * 2000 + 16 * 10000
    least = max(f / rl.PEAK_FLOPS, b / rl.PEAK_BYTES)
    assert rl.roofline_pct([(f, b)], least * 4) == pytest.approx(25.0)
    assert rl.roofline_pct([(f, b)], 0.0) is None
    t = tr.Trace(device_ops=[("void rasterize_fwd_kernel<6>", 0, 2)],
                 host_ops=[], iters=1, window_s=1e-3)
    pct = run.metric_reader("k3_roofline.view")({"trace": t, "work": [c]})
    assert pct == pytest.approx(100 * least / 2e-6)
    mfu = run.metric_reader("frame_mfu.view")({"trace": t, "work": [c, c],
                                                "iter_s": 1e-3})
    assert mfu == pytest.approx(100 * rl.frame_flops(c) / (1e-3 * 67e12))
    assert math.isfinite(rl.train_step_flops(c))


def test_readers_find_nothing_in_an_empty_trace():
    t = tr.Trace(device_ops=[], host_ops=[], iters=3, window_s=1.0)
    c = Counts(1, 1, 1, 1, 1, 1)
    for name in ("device_idle.view", "ops_per_frame.view",
                 "torch_glue_ms.train", "raster_roofline.train",
                 "segsum_roofline.train", "step_mfu.train",
                 "k3_roofline.view", "frame_mfu.view"):
        assert run.metric_reader(name)({"trace": t, "work": [c],
                                        "iter_s": 1.0}) is None


def test_idle_gaps_named_by_the_host_operation():
    dev = [("k1", 0, 10), ("k2", 30, 40), ("k3", 100, 110)]
    host = [("step", 0, 200), ("aten::cat", 12, 28), ("aten::mul", 50, 90)]
    t = tr.Trace(device_ops=[], host_ops=host, iters=1, window_s=1e-4,
                 gap_ops=dev)
    gaps = dict(tr.idle_gaps(t))
    assert gaps == {"aten::mul": pytest.approx(60e-6),
                    "aten::cat": pytest.approx(20e-6)}
    assert tr.top_device_ops(dev, 2) == [["k1", 1e-5], ["k2", 1e-5]]
