"""The control of ``correct``, and the faults it must catch, at cell size.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

Runs no program. For each seed it builds the cell's inputs as a run
does, computes the reference in float32, and reads the numbers that
``correct`` compares for:

- ``control``: the reference itself in bfloat16 (the precision below the
  configuration's float32), put in the program's place;
- the planted faults a cell of its kind can have: for training,
  ``half_rows`` (the loss over half the image, its mean taken there) and
  ``drop_opacity_grad`` (one parameter's gradient lost where it is
  produced); for a viewer, ``stale_frame`` (the previous frame's image
  returned), ``half_rows`` (half the image left black) and
  ``tile_lost`` (one 16 x 16 tile left black). A state left unchanged
  reads 1 by ``loops.gaps`` and needs no run.

Each reading is a JSON line on standard output. The limits in
``limits/<cell>.json`` lie between the program's readings over seeds and
the least of these.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import torch

from . import loops
from . import run as harness
from . import scene as sc
from .reference import render as rr
from .reference import train as rt


def train_readings(loop: loops.TrainLoop) -> dict:
    loop.ref_views = loop.views()
    order = loop.schedule()
    checked = [next(order) for _ in range(int(loop.traffic["checked_steps"]))]
    rr.plain_precision()
    scene = sc.draw_scene(loop.cfg, loop.seed, loop.device)
    views = [loop.ref_views[v] for v in checked]
    lrs, eps, n = loop.lrs(), loop.traffic["adam_eps"], len(views)
    targets = [rt.target_image(scene, v) for v in views]
    ref = rt.train(scene, views, targets, lrs, eps, n)
    out = {}
    low = [rt.target_image(scene, v, torch.bfloat16) for v in views]
    out["control"] = loops.gaps(
        rt.train(scene, views, low, lrs, eps, n, torch.bfloat16), ref)
    del low
    for fault in ("half_rows", "drop_opacity_grad"):
        out[fault] = loops.gaps(
            rt.train(scene, views, targets, lrs, eps, n, fault=fault), ref)
    return out


def view_readings(loop: loops.ViewLoop) -> dict:
    loop.path()
    t = loop.traffic
    loop.ref_views = [sc.orbit_view(loop.cfg, t, a, float(t["elevation_deg"]))
                      for a in loop.azimuths]
    rng = random.Random(loop.seed)
    frames = [loop.frame_view(rng.randrange(loop.period))
              for _ in range(int(t["sample_frames"]))]
    rr.plain_precision()
    ref_in = loop.inputs(torch.float32)
    low_in = loop.inputs(torch.bfloat16)
    res = {f: {} for f in ("control", "stale_frame", "half_rows",
                           "tile_lost")}
    for v in frames:
        view = loop.ref_views[v]
        img, tr, _ = rr.render(*rr.splat_columns(*ref_in, view), view.width,
                               view.height)
        lo_img, lo_tr, _ = rr.render(*rr.splat_columns(*low_in, view),
                                     view.width, view.height)
        # The previous frame's view along the sweep.
        prev = loop.ref_views[v - 1 if v else 1]
        h, w = view.height, view.width
        half_img, half_tr = img.clone(), tr.clone()
        half_img[h // 2:] = 0.0
        half_tr[h // 2:] = 1.0
        tile_img, tile_tr = img.clone(), tr.clone()
        y0, x0 = (h // 2) // 16 * 16, (w // 2) // 16 * 16
        tile_img[y0:y0 + 16, x0:x0 + 16] = 0.0
        tile_tr[y0:y0 + 16, x0:x0 + 16] = 1.0
        got = {"control": (lo_img, lo_tr),
               "stale_frame": rr.render(*rr.splat_columns(*ref_in, prev),
                                        prev.width, prev.height)[:2],
               "half_rows": (half_img, half_tr),
               "tile_lost": (tile_img, tile_tr)}
        for name, (gi, gt_) in got.items():
            r = res[name]
            r["image_gap"] = max(r.get("image_gap", 0.0),
                                 loops.rel_l2(gi, img))
            r["trans_gap"] = max(r.get("trans_gap", 0.0),
                                 loops.rel_l2(gt_, tr))
    return res


def readings(spec: dict, seed: int, device) -> dict:
    loop = loops.LOOPS[spec["traffic"]["loop"]](
        spec["config"], spec["traffic"], seed, device)
    if loop.kind == "train":
        return train_readings(loop)
    return view_readings(loop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = harness.load_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(spec, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "limits": spec["limits"], "readings": out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
