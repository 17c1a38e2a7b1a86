"""benchmark/spans.py on a hand-made trace: each device operation goes to
the innermost program span open at its launch, nested self times, the
operations in no span, launches that cannot be matched, and the readers'
None where the program opened no span."""

import pytest

from benchmark import run, spans
from benchmark.trace import Trace

# Host: a marker launched before the step (left out), a step holding
# constrain and, on the autograd thread, bin_bwd with reorder inside; a
# copy read after the step, outside every span.
HOST = [("cudaLaunchKernel", -50, -49),
        ("train.step", 0, 100), ("train.constrain", 5, 10),
        ("cudaLaunchKernel", 6, 7), ("aten::mul", 19, 22),
        ("cudaLaunchKernel", 20, 21), ("render.bin_bwd", 50, 80),
        ("cudaLaunchKernel", 55, 56), ("render.reorder", 60, 70),
        ("cudaLaunchKernelExC", 65, 66), ("cudaMemsetAsync", 66, 67),
        ("cudaMemcpyAsync", 120, 121), ("cudaStreamSynchronize", 121, 130)]
# Device: the same operations later, in launch order, with durations
# 1000, 2000, 3000, 4000, 500 and 100 us.
DEVICE = [("constrain_kernel", 200, 1200), ("mul_kernel", 1200, 3200),
          ("rasterize_bwd_kernel", 3300, 6300),
          ("segment_sums_kernel", 6300, 10300), ("Memset (Device)", 10400,
                                                 10900),
          ("Memcpy DtoH (Device -> Pageable)", 11000, 11100)]


def _trace(host=HOST, device=DEVICE):
    host = sorted(host, key=lambda h: h[1])
    return Trace(device_ops=[], host_ops=host, iters=1, window_s=1.0,
                 gap_ops=list(device))


def test_self_times_nest_and_the_rest_is_in_no_span():
    split = spans.stage_split(_trace(), "train")
    assert split.iters == 1
    assert split.self_ms == {"train.step": 2.0, "train.constrain": 1.0,
                             "render.bin_bwd": 3.0, "render.reorder": 4.5}
    assert split.no_span_ms == pytest.approx(0.1)
    assert split.total_ms == pytest.approx(10.6)
    assert split.no_span_share == pytest.approx(0.1 / 10.6)
    ctx = dict(kind="train", trace=_trace())
    assert run.metric_reader("reorder_ms.train")(ctx) == 4.5
    assert run.metric_reader("autograd_ms.train")(ctx) == 2.0
    assert run.metric_reader("transform_ms.train")(ctx) == 1.0
    # A span the block never opened reads nothing.
    assert run.metric_reader("adam_ms.train")(ctx) is None


def test_two_iterations_halve_and_unmatched_launches_read_nothing():
    shifted = [(n, s + 200, e + 200) for n, s, e in HOST[1:]]
    later = [(n, s + 20000, e + 20000) for n, s, e in DEVICE]
    split = spans.stage_split(_trace(HOST + shifted, DEVICE + later), "train")
    assert split.iters == 2
    assert split.self_ms["render.reorder"] == 4.5
    # One device operation more than the host launched: no match.
    extra = DEVICE + [("elementwise_kernel", 12000, 12010)]
    assert spans.stage_split(_trace(device=extra), "train") is None


def test_readers_find_nothing_without_spans():
    bare = [h for h in HOST if h[0] not in spans.SPANS]
    for kind, names in (("train", ["transform_ms.train", "project_ms.train",
                                   "bin_ms.train", "reorder_ms.train",
                                   "autograd_ms.train", "adam_ms.train"]),
                        ("view", ["transform_ms.view", "project_ms.view",
                                  "bin_ms.view"])):
        for trace in (_trace(bare), _trace(device=[])):
            ctx = dict(kind=kind, trace=trace)
            assert all(run.metric_reader(n)(ctx) is None for n in names)


def test_idle_gaps_go_to_the_innermost_span_open_on_the_host():
    host = sorted([("train.step", 0, 100), ("train.adam", 40, 60)],
                  key=lambda h: h[1])
    device = [("a", 0, 10), ("b", 30, 45), ("c", 55, 58), ("d", 200, 201)]
    idle = spans.idle_by_span(_trace(host, device))
    assert [k for k, _ in idle] == [spans.NO_SPAN, "train.step",
                                    "train.adam"]
    assert [v for _, v in idle] == pytest.approx([142e-6, 20e-6, 10e-6])
