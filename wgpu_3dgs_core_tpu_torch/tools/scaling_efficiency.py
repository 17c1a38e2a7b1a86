"""Strong-scaling efficiency of ``render_sharded``.

The counterpart of ``tools/scaling_efficiency.py``: the forward +
backward step of mean((image - 0)^2) w.r.t. (means, cov3d, colour,
opacity, sh) on the port bench's scene and camera (``bench.py``), and:

- ``plain_1dev_ms``: the port's ``render`` step, in this process;
- ``route_build_8dst_ms``: ``parallel/sharded.py::_route_to_strips`` at
  D = 8 and N_local = N / 8 on the JAX tool's draws and capacity
  (:func:`route_inputs`), as a plain function in this process;
- for D in (1, 2, 4, 8) up to the ranks available, ``sharded_{D}dev_ms``
  and ``efficiency_{D}dev`` = t(1) / (D t(D)): D ranks spawned by
  ``parallel/launch.py::spawn_ranks`` run ``render_step``, and t(D) is
  the largest, over the ranks, of each rank's median step;
- ``sharding_overhead_1dev`` = sharded_1dev_ms / plain_1dev_ms.

Each time is the wall time a step, the device synchronised around the
steps, after one step that is not timed (``bench.py::time_steps`` in
this process, ``render_step``'s ``time_steps`` on a rank). The JSON
line has the JAX tool's keys, the device
(``utils/profiling.py::device_name``), the backend, and each rank's
kernel launches over one sharded step (those launched at least once:
none on the CPU, where the plain versions run).

On a CUDA card (the default) the ranks use NCCL, one card a rank, so one
card gives D = 1 only: ranks sharing one card under gloo would time the
host's staging, not scaling. ``--device cpu`` runs gloo ranks on the CPU,
as the JAX tool's virtual CPU mesh does, up to 8 (its times are the
host's, no device numbers). ``--max-devices`` caps D.

    python -m wgpu_3dgs_core_tpu_torch.tools.scaling_efficiency \\
        [--gaussians 65536] [--width 512] [--height 512] \\
        [--max-fragments 262144] [--iters 3] [--max-devices D] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Optional, Sequence

import numpy as np
import torch

from ..bench import bench_camera, leaves, synthetic_scene, time_steps
from ..parallel.launch import render_step, spawn_ranks
from ..parallel.sharded import _route_to_strips
from ..render.renderer import render
from ..utils.profiling import device_name
from .stages import require_card

SIZES = (1, 2, 4, 8)  # the mesh sizes the JAX tool reads
CPU_RANKS = 8  # the JAX tool's virtual CPU devices
ROUTE_DEVICES = 8
SH_DEG = 3
RANKS_TIMEOUT = 600.0  # seconds one spawn of ranks may take


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaussians", type=int, default=65536)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--max-fragments", type=int, default=262144)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max-devices", type=int, default=None,
                    help="largest D read (default: every card, or 8 on "
                         "the CPU)")
    ap.add_argument("--device", default="cuda")
    return ap


def route_inputs(gaussians: int) -> tuple:
    """The JAX tool's route inputs at D = 8: (packed [N/8, 13] f32, s0,
    s1 int32) drawn in its order, and its per-destination capacity."""
    n_loc = gaussians // ROUTE_DEVICES
    rng = np.random.default_rng(0)
    packed = rng.random((n_loc, 13)).astype(np.float32)
    s0 = rng.integers(0, ROUTE_DEVICES, n_loc).astype(np.int32)
    s1 = np.clip(s0 + rng.integers(0, 2, n_loc).astype(np.int32), 0,
                 ROUTE_DEVICES - 1).astype(np.int32)
    cap = max(128, int(n_loc * 2.0 / ROUTE_DEVICES) // 128 * 128)
    return (packed, s0, s1), cap


def route(tensors, cap: int):
    """The route build at D = 8 on (packed, s0, s1) tensors of
    :func:`route_inputs`' arrays: (send [8, cap, 13], overflowed)."""
    return _route_to_strips(*tensors, ROUTE_DEVICES, cap)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cpu":
        backend, avail = "gloo", CPU_RANKS
    else:
        dev = require_card(dev, "scaling_efficiency")
        backend, avail = "nccl", torch.cuda.device_count()
    if args.max_devices is not None:
        if args.max_devices < 1:
            ap.error("--max-devices must be at least 1")
        avail = min(avail, args.max_devices)

    cam = bench_camera(args.width, args.height)
    scene = synthetic_scene(args.gaussians, device="cpu")
    params = leaves([t.to(dev) for t in scene])
    results: dict = {}

    def plain_step(params):
        res = render(*params[:4], cam, sh=params[4], sh_deg=SH_DEG,
                     max_fragments=args.max_fragments)
        loss = torch.mean(res.image ** 2)
        return loss, torch.autograd.grad(loss, params)

    t_plain, _ = time_steps(plain_step, params, 1, args.iters)
    results["plain_1dev_ms"] = t_plain * 1e3
    print(f"plain render 1 dev: {t_plain * 1e3:9.3f} ms", flush=True)
    del params

    arrays, cap = route_inputs(args.gaussians)
    t_route, _ = time_steps(lambda t: route(t, cap),
                            [torch.from_numpy(a).to(dev) for a in arrays],
                            1, args.iters)
    results["route_build_8dst_ms"] = t_route * 1e3
    print(f"route_to_strips build (D={ROUTE_DEVICES}, N_local="
          f"{arrays[0].shape[0]}, cap={cap}): {t_route * 1e3:9.3f} ms",
          flush=True)

    scene_np = tuple(t.numpy() for t in scene)
    case = dict(sh_deg=SH_DEG, max_fragments=args.max_fragments)
    launches = {}
    t1 = None
    for d in (d for d in SIZES if d <= avail):
        ranks = spawn_ranks(render_step, d, (scene_np, cam, [case], None,
                                             False, args.iters),
                            backend=backend, device=dev.type,
                            timeout=RANKS_TIMEOUT)
        t = max(statistics.median(r[0]["step_ms"]) for r in ranks) / 1e3
        t1 = t if d == 1 else t1
        eff = t1 / (d * t)
        results[f"sharded_{d}dev_ms"] = t * 1e3
        results[f"efficiency_{d}dev"] = eff
        launches[str(d)] = [{k: v for k, v in r[0]["launches"].items() if v}
                            for r in ranks]
        print(f"sharded {d} dev: {t * 1e3:9.3f} ms  strong-scaling eff "
              f"{eff * 100:5.1f}%", flush=True)

    results["sharding_overhead_1dev"] = (results["sharded_1dev_ms"]
                                         / results["plain_1dev_ms"])
    results.update(device=device_name(dev), backend=backend,
                   launches=launches)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
