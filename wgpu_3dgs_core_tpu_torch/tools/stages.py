"""What the stage-reading tools share: the bench setup, the forward
prefix of the bench step, and the reading of stages on the card.

The tools (the attribution tools ``profile_components``, ``bench_bin``,
``bench_bwd``, ``bench_nscale``, on the bench setup, and the tools on
drawn data ``bench_sort_shapes``, ``bench_irregular_ops``,
``bench_reorder``, ``bench_reorder2``) each build a dict of stages:
callables of no argument, each returning its output, that run on any
device (the CPU tests call them). Their ``main`` reads the stages on a
CUDA card only, through :func:`read_stages`:

- **device ms**: the median, over ``iters`` back-to-back calls, of each
  call's device operations summed (``utils/profiling.py::device_calls``),
  and the mean device ms a call by kernel kind (``KERNEL_KINDS``);
- **operations** a call: device kernels, copies and fills;
- **host enqueue ms against wall ms** a call over ``iters`` back-to-back
  calls, the card synchronised once after them (equal: the host paces
  the card);

and, by one call before them, the kernels the stage launched
(``ops/cuda.py::launch_counts``) and, where its output is a dict holding
"overflow", whether a capacity overflowed; and the profiler sessions the
device reading took (more than one: a session lost an operation and was
made again).
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Optional

import torch

from ..bench import CAPACITIES, bench_camera, leaves, synthetic_scene
from ..ops.binning import (
    CHUNK,
    bin_splats_attrs,
    num_tiles,
    pad_schedule,
    padded_capacity,
)
from ..ops.cuda import launch_counts, reset_launch_counts
from ..ops.rasterize import rasterize_tiles_fwd
from ..ops.sh import gaussian_color
from ..render.reference import view_dirs
from ..render.renderer import (
    attribute_columns,
    project_splats,
    tile_local_stream,
)
from ..utils.profiling import (
    PROFILER_STATS,
    device_calls,
    device_name,
    host_pace_ms,
    kind_ms,
)

# The bench step's blend settings: SPLAT mode's cutoff, its background.
CUTOFF_SQ = 9.0
BACKGROUND = (0.0, 0.0, 0.0)
# The forward's prefixes, each containing the one before.
FORWARD_PREFIX = ("project", "color", "bin", "sched", "gather")
TOP_KINDS = 3  # kinds printed on a stage's line


def bench_parser(description: str) -> argparse.ArgumentParser:
    """The arguments every tool takes: the port bench's scene, camera and
    capacities (``bench.py::synthetic_scene``, ``CAPACITIES``), the calls
    a reading makes, and the device."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--max-fragments", type=int,
                    default=CAPACITIES["max_fragments"])
    ap.add_argument("--max-rows", type=int, default=CAPACITIES["max_rows"])
    ap.add_argument("--pad-slack", type=float, default=0.65)
    ap.add_argument("--sh-deg", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def require_card(device, tool: str) -> torch.device:
    """The CUDA device a tool reads its stages on; anything else raises:
    a time taken on the CPU is no device number, and there is no
    fallback."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{tool} reads device time on a CUDA card; got "
                         f"device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: no CUDA card "
                           "(torch.cuda.is_available() is false)")
    return dev


def bench_setup(args, device):
    """The bench scene as five leaf tensors requiring grad (means, cov6,
    colour, opacity, sh) on ``device``, and its camera."""
    params = leaves(synthetic_scene(args.gaussians, device=device))
    return params, bench_camera(args.width, args.height)


def stream_capacity(max_fragments: int) -> int:
    """The fragment capacity ``render`` bins with: whole CHUNK blocks."""
    return -(-max_fragments // CHUNK) * CHUNK


@torch.no_grad()
def forward_prefix(params, camera, max_fragments: int, max_rows: int,
                   pad_slack: float, sh_deg: int, upto: str) -> dict:
    """The forward of ``render`` (SPLAT mode, no model transform, the
    bench's background) up to and including the stage ``upto`` of
    FORWARD_PREFIX, op for op as ``render`` runs it, without autograd:

    - project: ``project_splats`` (splats, opacity);
    - color: the SH colour (rgb) and the attribute columns (attr_cols);
    - bin: ``bin_splats_attrs`` (stream, attrs_sorted, table): K1, K2,
      the tile sort and the tile ranges;
    - sched: ``pad_schedule`` (sched);
    - gather: ``tile_local_stream`` (frags) and K3 (tiles).

    Returns the pieces made so far, and from bin on "overflow"."""
    if upto not in FORWARD_PREFIX:
        raise ValueError(f"upto {upto!r} is none of {FORWARD_PREFIX}")
    means, cov6, color, opac, sh = params
    tiles_x, tiles_y = num_tiles(camera.width, camera.height)
    splats, opacity = project_splats(means, cov6, opac, camera)
    out = dict(splats=splats, opacity=opacity)
    if upto == "project":
        return out
    rgb = gaussian_color(color, sh, view_dirs(means, camera), sh_deg)
    attr_cols = attribute_columns(splats.xy, splats.conic, rgb, opacity,
                                  splats.mask)
    out.update(rgb=rgb, attr_cols=attr_cols)
    if upto == "color":
        return out
    f_cap = stream_capacity(max_fragments)
    stream, attrs_sorted, table = bin_splats_attrs(
        splats.xy, splats.extent, splats.depth, splats.mask, attr_cols,
        tiles_x, tiles_y, f_cap, max_rows=max_rows, cutoff_sq=CUTOFF_SQ)
    out.update(stream=stream, attrs_sorted=attrs_sorted, table=table,
               overflow=stream.overflow)
    if upto == "bin":
        return out
    sched = pad_schedule(stream,
                         padded_capacity(f_cap, tiles_x * tiles_y, pad_slack))
    out.update(sched=sched, overflow=stream.overflow | sched.truncated)
    if upto == "sched":
        return out
    frags = tile_local_stream(attrs_sorted, stream.tile_id, tiles_x)
    tiles = rasterize_tiles_fwd(frags, stream.tile_start, sched.draw_len,
                                BACKGROUND, CUTOFF_SQ, 0)
    out.update(frags=frags, tiles=tiles)
    return out


def read_stage(fn: Callable, iters: int) -> dict:
    """One stage's reading on the card (the module's docstring)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    overflow = (bool(out["overflow"])
                if isinstance(out, dict) and "overflow" in out else None)
    del out  # its memory is free for the calls read below
    enqueue_ms, wall_ms = host_pace_ms(fn, iters=iters)
    sessions = PROFILER_STATS["sessions"]
    calls = device_calls(fn, iters=iters)
    return {
        "device_ms": statistics.median(
            sum(e.time_range.elapsed_us() for e in call)
            for call in calls) / 1e3,
        "ops": len(calls[0]),
        "enqueue_ms": enqueue_ms,
        "wall_ms": wall_ms,
        "by_kind": kind_ms(calls),
        "launches": launches,
        "overflow": overflow,
        "profiler_sessions": PROFILER_STATS["sessions"] - sessions,
    }


def stage_line(name: str, r: dict) -> str:
    top = list(r["by_kind"].items())[:TOP_KINDS]
    return (f"{name:>18s}: device {r['device_ms']:.4f} ms, {r['ops']} ops, "
            f"host enqueue {r['enqueue_ms']:.3f} / wall {r['wall_ms']:.3f} "
            f"ms; launches {r['launches']}; overflow {r['overflow']}; "
            f"profiler sessions {r['profiler_sessions']}; top kinds "
            + ", ".join(f"{k} {v:.4f}" for k, v in top))


def read_stages(stages: dict, iters: int) -> dict:
    """Each stage's reading, in order, a line printed for each."""
    readings = {}
    for name, fn in stages.items():
        readings[name] = read_stage(fn, iters)
        print(stage_line(name, readings[name]), flush=True)
    return readings


def slice_of(plus: list, minus: list) -> dict:
    """A derived slice: the device ms and ms by kind of the readings
    ``plus`` less those of ``minus``."""
    by_kind: dict = {}
    for sign, readings in ((1.0, plus), (-1.0, minus)):
        for r in readings:
            for k, v in r["by_kind"].items():
                by_kind[k] = by_kind.get(k, 0.0) + sign * v
    return {
        "device_ms": (sum(r["device_ms"] for r in plus)
                      - sum(r["device_ms"] for r in minus)),
        "by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
    }


def report(tool: str, device, args, readings: dict,
           derived: Optional[dict] = None) -> dict:
    """Print the derived slices and the tool's JSON line (its device, its
    arguments, every reading); return that line as a dict."""
    for name, d in (derived or {}).items():
        top = list(d["by_kind"].items())[:TOP_KINDS]
        share = f", {d['share']:.3f} of the step" if "share" in d else ""
        print(f"{name:>18s}: device {d['device_ms']:.4f} ms (derived"
              f"{share}); top kinds "
              + ", ".join(f"{k} {v:.4f}" for k, v in top), flush=True)
    result = {"tool": tool, "device": device_name(device),
              "args": {k: v for k, v in vars(args).items()
                       if k != "device"},
              "stages": readings, "derived": derived or {}}
    print(json.dumps(result), flush=True)
    return result
