"""``correct`` comes out false when the timed path is broken underneath:
each fault a cell of its kind can have, planted in the port for a toy
run on the CPU; and the control (the reference in bfloat16) fails the
committed limits."""

import pytest
import torch

from benchmark import control, loops, run
from benchmark.tests.conftest import toy_spec

SEED = 2 ** 31 + 77


def toy_run(cell):
    return run.run_cell(toy_spec(cell), SEED, 0.2, False, "cpu")[0]


def train_fault(name, monkeypatch):
    P = loops.port()
    if name == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif name == "half_rows":
        def half(image, target):
            h = image.shape[0] // 2
            return torch.mean((image[:h] - target[:h]) ** 2)
        monkeypatch.setattr(P["train"], "l2_image_loss", half)
    elif name == "drop_opacity_grad":
        inner = P["renderer"].reorder_grads

        def dropped(*a):
            d = inner(*a).clone()
            d[8] = 0.0
            return d
        monkeypatch.setattr(P["renderer"], "reorder_grads", dropped)


def view_fault(name, monkeypatch):
    P = loops.port()
    inner = P["renderer"].render_gaussians
    last = []

    def broken(*a, **k):
        res = inner(*a, **k)
        img, tr = res.image.clone(), res.transmittance.clone()
        if name == "stale_frame":
            if last:
                img, tr = last[0]
            last[:] = [(res.image.clone(), res.transmittance.clone())]
        elif name == "half_rows":
            img[img.shape[0] // 2:] = 0.0
            tr[tr.shape[0] // 2:] = 1.0
        elif name == "tile_lost":
            img[16:32, 32:48] = 0.0
            tr[16:32, 32:48] = 1.0
        return res._replace(image=img, transmittance=tr)
    monkeypatch.setattr(P["renderer"], "render_gaussians", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_rows",
                                   "drop_opacity_grad"])
def test_train_fault_is_caught(fault, monkeypatch):
    train_fault(fault, monkeypatch)
    result = toy_run("synth1m-train")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["stale_frame", "half_rows", "tile_lost"])
def test_view_fault_is_caught(fault, monkeypatch):
    view_fault(fault, monkeypatch)
    result = toy_run("bicycle6m-view")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["synth1m-train", "bicycle6m-view"])
def test_control_fails_the_limits(cell):
    spec = toy_spec(cell)
    out = control.readings(spec, SEED, "cpu")
    for name, nums in out.items():
        assert any(nums[k] > spec["limits"][k] for k in spec["limits"]), \
            (name, nums)


def test_fault_once_warm_is_caught(monkeypatch):
    """A fault that sets in only once the path is warm, from the window
    on (as a replayed graph with a stale input would): the checked steps
    run after the window through the same step objects, and catch it."""
    P = loops.port()
    inner = P["train"].render
    warm = []
    monkeypatch.setattr(loops.TrainLoop, "start_window",
                        lambda self: warm.append(True))

    def altered(*a, **k):
        res = inner(*a, **k)
        return res._replace(image=res.image * 0.9) if warm else res
    monkeypatch.setattr(P["train"], "render", altered)
    result = toy_run("synth1m-train")
    assert warm and not result["correct"], result["checks"]
