"""The port's stage spans and counters (``utils/profiling.py``) on the CPU:
a training step and a viewer frame under ``trace`` show every stage span,
nested as the step nests them; ``named_scope`` costs nothing while no
profiler records; a ``counting`` session holds each binning call's
fragments, rows and their capacities, and ``count`` without one records
nothing. No JAX: the spans are the port's alone.
"""

import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu_torch as T
from wgpu_3dgs_core_tpu_torch.ops.binning import (
    CHUNK,
    bin_splats_attrs,
    gaussian_table,
    num_tiles,
    row_capacity,
)
from wgpu_3dgs_core_tpu_torch.render import renderer as R
from wgpu_3dgs_core_tpu_torch.render.camera import Camera
from wgpu_3dgs_core_tpu_torch.render.train import (
    TrainableGaussians,
    make_train_step,
)
from wgpu_3dgs_core_tpu_torch.utils import profiling as tpf

from .torch_parity import one_torch_thread, random_scene  # noqa: F401

N, W, H = 300, 64, 48
CAM = Camera.look_at((0.0, 0.0, -6.0), (0.0, 0.0, 0.0), width=W, height=H)
MAX_FRAGMENTS = 4096
# Every span a frame or a step opens, and the span each lies inside.
FRAME_SPANS = {"render.unpack": None, "render.project": None,
               "render.bin": None, "render.raster": None}
STEP_SPANS = {"train.step": None, "train.constrain": "train.step",
              "train.adam": "train.step", "render.project": "train.step",
              "render.bin": "train.step", "render.raster": "train.step",
              "render.bin_bwd": "train.step",
              "render.reorder": "render.bin_bwd"}


def _trainable():
    means, quats, scales, color, opac, sh = random_scene(N, 3)
    t = torch.from_numpy
    return TrainableGaussians(
        means=t(means), quats=t(quats), log_scales=torch.log(t(scales)),
        color_logit=torch.logit(t(color)), opacity_logit=torch.logit(t(opac)),
        sh=t(sh))


def _buffer():
    means, quats, scales, color, opac, sh = random_scene(N, 3)
    rgba = np.concatenate([color, opac[:, None]], axis=1)
    soa = T.GaussianSoA(rot=quats, pos=means, sh=sh, scale=scales,
                        color=np.round(rgba * 255).astype(np.uint8))
    return T.GaussiansBuffer.new(soa, device="cpu")


def _train_step():
    params = _trainable()
    opt = torch.optim.Adam(params.parameters(), lr=1e-3)
    step = make_train_step(CAM, torch.zeros(H, W, 3), opt, sh_deg=3,
                           max_fragments=MAX_FRAGMENTS)
    return lambda: step(params)


def _frame():
    buf = _buffer()
    return lambda: R.render_gaussians(buf, CAM,
                                      max_fragments=MAX_FRAGMENTS)


def _ancestors(e):
    out = []
    while (e := e.cpu_parent) is not None:
        out.append(e.name)
    return out


@pytest.mark.parametrize("what", ["step", "frame"])
def test_stage_spans_show_nested_in_the_trace(what, tmp_path,
                                              one_torch_thread):
    run, spans = ((_train_step(), STEP_SPANS) if what == "step"
                  else (_frame(), FRAME_SPANS))
    assert not bool(run()[-1])
    with tpf.trace(str(tmp_path)) as prof:
        run()
    found = {}
    for e in prof.events():
        if e.name.startswith(("train.", "render.")):
            found.setdefault(e.name, []).append(_ancestors(e))
    assert set(found) == set(spans)
    for name, parent in spans.items():
        for anc in found[name]:
            # No stage span inside another but where the table says.
            stages = [a for a in anc if a in spans]
            assert stages[:1] == ([parent] if parent else []), (name, anc)
    # The bin and raster stages open once each in the forward's binned
    # rasterization, the binning once more for the attribute columns,
    # the rasterizer twice more for the composite and the image.
    assert len(found["render.bin"]) == 2 and len(found["render.raster"]) == 3


def test_named_scope_is_free_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert tpf.named_scope("render.bin") is tpf.named_scope("train.step")
    with tpf.named_scope("render.bin"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        scope = tpf.named_scope("render.bin")
        assert scope is not tpf.named_scope("render.bin")
        with scope:
            pass


def test_counting_holds_the_stream_fragments_and_capacity(one_torch_thread):
    params = _trainable()
    means, cov6, color, opac, sh = params.constrained()
    with torch.no_grad(), tpf.counting() as rec:
        for _ in range(2):
            R.render(means, cov6, color, opac, CAM, sh=sh, sh_deg=3,
                     max_fragments=MAX_FRAGMENTS - 1)
    sums, calls = rec.totals()
    assert calls == {"fragments": 2, "capacity": 2, "overflow": 2,
                     "rows": 2, "row_capacity": 2}
    # The same call's stream, binned again outside the session.
    f_cap = -(-(MAX_FRAGMENTS - 1) // CHUNK) * CHUNK
    with torch.no_grad():
        splats, rgb, op = R.project_and_color(means, cov6, color, opac, CAM,
                                              sh=sh, sh_deg=3)
        cols = R.attribute_columns(splats.xy, splats.conic, rgb, op,
                                   splats.mask)
        tx, ty = num_tiles(W, H)
        stream, _, _ = bin_splats_attrs(splats.xy, splats.extent,
                                        splats.depth, splats.mask, cols, tx,
                                        ty, f_cap)
        _, total_rows = gaussian_table(splats.xy, splats.extent,
                                       splats.depth, splats.mask, cols, tx,
                                       ty)
    frags, rows, r_cap = (int(stream.num_fragments), int(total_rows),
                          row_capacity(f_cap))
    assert 0 < frags < f_cap and 0 < rows < r_cap
    assert sums == {"fragments": 2 * frags, "capacity": 2 * f_cap,
                    "overflow": 0, "rows": 2 * rows,
                    "row_capacity": 2 * r_cap}
    assert all(type(v) is int for v in sums.values())


def test_count_without_a_session_records_nothing():
    tpf.count("fragments", torch.tensor(5))
    with tpf.counting() as rec:
        tpf.count("fragments", torch.tensor(7))
        tpf.count("capacity", 10)
        with tpf.counting() as inner:
            tpf.count("fragments", 1)
        tpf.count("fragments", 2.5)
    tpf.count("capacity", 3)
    assert rec.totals() == ({"fragments": 9.5, "capacity": 10},
                            {"fragments": 2, "capacity": 1})
    assert inner.totals() == ({"fragments": 1}, {"fragments": 1})
    assert tpf._COUNTS is None
