"""The training step by stage on the card: the bench step's prefixes, its
rasterizer kernels alone, and the backward's tail and N-scale autograd.

The counterpart of ``tools/profile_components.py``, on the port's
pipeline as it stands. Prefix stages of the port bench's step, each
containing the one before (``tools/stages.py::forward_prefix``; the
forward ones without autograd, as the bench's forward runs):

- ``project``: ``render/renderer.py::project_splats``;
- ``color``: + the SH colour and the attribute columns;
- ``bin``: + ``ops/binning.py::bin_splats_attrs`` (K1, K2, the tile
  sort, K14's tile-local stream, the tile ranges);
- ``sched``: + ``pad_schedule``;
- ``gather``: + K3;
- ``fwd``: ``render`` and the loss, mean(image^2);
- ``step``: ``bench.py::make_step``, forward + backward w.r.t. (means,
  cov6, colour, opacity, sh).

Kernel stages, on inputs made outside the timer by one ``gather``:
``kernel_fwd`` (K3) and ``kernel_fwd_bwd`` (K3, then K4 with the
cotangent tiles * 1e-3). From ``tools/bench_bwd.py``: ``reorder`` (the
backward's tail) and ``nscale`` (the autograd of projection and colour).
Derived slices, the JAX tool's: ``kernel_bwd`` = kernel_fwd_bwd -
kernel_fwd, ``gather_slice`` = gather - sched, ``kernel_fwd_slice`` = fwd
- gather, ``glue_bwd`` = step - fwd - kernel_bwd (the JAX tool's
``xla_bwd``: the backward's work outside K4, in torch ops and K5, K6);
and the rest of a partition of the step: ``sh_colour`` = color - project,
``binning`` = bin - color, ``sched_slice`` = sched - bin, ``nscale_bwd``
= nscale - color (the N-scale autograd's backward), ``glue_bwd_rest`` =
glue_bwd - nscale_bwd - reorder. project, sh_colour, binning,
sched_slice, gather_slice, kernel_fwd_slice, kernel_bwd, nscale_bwd,
reorder and glue_bwd_rest sum to the step; each derived slice carries
its share of the step's device ms.

    python -m wgpu_3dgs_core_tpu_torch.tools.profile_components \\
        [--gaussians 1000000] [--width 1920] [--height 1080] \\
        [--max-fragments 2957312] [--max-rows 1887232] [--pad-slack 0.65] \\
        [--sh-deg 3] [--iters 10] [--device cuda]

Prints a line per stage and derived slice, then one JSON line naming the
device (``tools/stages.py``). Reads on a CUDA card only. The JAX tool's
``--chunk`` has no counterpart: the port's ``CHUNK`` is fixed.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..bench import make_step
from ..ops.rasterize import rasterize_tiles_bwd, rasterize_tiles_fwd
from . import bench_bwd
from .stages import (
    BACKGROUND,
    CUTOFF_SQ,
    FORWARD_PREFIX,
    bench_parser,
    bench_setup,
    forward_prefix,
    read_stages,
    report,
    require_card,
    slice_of,
)


def kernel_inputs(gather: dict) -> tuple:
    """From a ``gather`` prefix's pieces: K3's arguments (frags,
    tile_start, draw_len, background, cutoff_sq, mode), and the tile
    lengths K4 takes besides."""
    stream, sched = gather["stream"], gather["sched"]
    return ((gather["frags"], stream.tile_start, sched.draw_len, BACKGROUND,
             CUTOFF_SQ, 0), sched.tile_len)


def kernel_fwd_bwd(k3: tuple, tile_len):
    """K3, then K4 on its tiles with the cotangent tiles * 1e-3 (the JAX
    tool's): K4's [9, F] gradients."""
    frags, tile_start, draw_len, bg, cutoff_sq, mode = k3
    tiles = rasterize_tiles_fwd(*k3)
    return rasterize_tiles_bwd(frags, tile_start, tile_len, draw_len, tiles,
                               tiles * 1e-3, bg, cutoff_sq, mode)


def stages(params, camera, max_fragments: int, max_rows: int,
           pad_slack: float, sh_deg: int) -> dict:
    """The tool's stages on ``params`` (five leaves requiring grad) and
    ``camera``, in reading order. Makes the kernel stages' and the
    reorder's inputs once, here."""
    cfg = (max_fragments, max_rows, pad_slack, sh_deg)
    out = {name: (lambda upto=name: forward_prefix(params, camera, *cfg,
                                                   upto))
           for name in FORWARD_PREFIX}
    step, forward = make_step(camera, max_fragments, max_rows, pad_slack,
                              sh_deg)
    out["fwd"] = lambda: dict(zip(("loss", "overflow"), forward(params)))
    out["step"] = lambda: dict(zip(("loss", "overflow", "grads"),
                                   step(params)))
    gather = forward_prefix(params, camera, *cfg, "gather")
    k3, tile_len = kernel_inputs(gather)
    out["kernel_fwd"] = lambda: rasterize_tiles_fwd(*k3)
    out["kernel_fwd_bwd"] = lambda: kernel_fwd_bwd(k3, tile_len)
    tail = bench_bwd.tail_inputs(gather, camera)
    out["reorder"] = lambda: bench_bwd.reorder(tail)
    out["nscale"] = lambda: bench_bwd.nscale(params, camera, sh_deg)
    return out


def derived(r: dict) -> dict:
    """The derived slices (the module's docstring) of the readings
    ``r``, each with its share of the step's device ms."""
    out = {
        "kernel_bwd": slice_of([r["kernel_fwd_bwd"]], [r["kernel_fwd"]]),
        "gather_slice": slice_of([r["gather"]], [r["sched"]]),
        "kernel_fwd_slice": slice_of([r["fwd"]], [r["gather"]]),
        "glue_bwd": slice_of([r["step"], r["kernel_fwd"]],
                             [r["fwd"], r["kernel_fwd_bwd"]]),
        "sh_colour": slice_of([r["color"]], [r["project"]]),
        "binning": slice_of([r["bin"]], [r["color"]]),
        "sched_slice": slice_of([r["sched"]], [r["bin"]]),
        "nscale_bwd": slice_of([r["nscale"]], [r["color"]]),
        "glue_bwd_rest": slice_of(
            [r["step"], r["kernel_fwd"], r["color"]],
            [r["fwd"], r["kernel_fwd_bwd"], r["nscale"], r["reorder"]]),
    }
    for d in out.values():
        d["share"] = d["device_ms"] / r["step"]["device_ms"]
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = bench_parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = require_card(args.device, "profile_components")
    params, camera = bench_setup(args, dev)
    readings = read_stages(
        stages(params, camera, args.max_fragments, args.max_rows,
               args.pad_slack, args.sh_deg), args.iters)
    return report("profile_components", dev, args, readings,
                  derived(readings))


if __name__ == "__main__":
    main()
