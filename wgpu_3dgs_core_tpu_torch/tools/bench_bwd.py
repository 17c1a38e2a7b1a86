"""The backward's work outside K4, by stage on the card.

The counterpart of ``tools/bench_bwd.py``, on the port's backward:

- ``reorder``: the tail of ``BinRasterize.backward``
  (``render/renderer.py::reorder_grads``): the stable sort of the slots by
  gaussian (``sort_keys``), the gid column, K5's sums and K6 back to
  gaussian order. It runs on the stream and K4 gradients of one real
  bench forward (:func:`tail_inputs`), where the JAX tool drew a random
  [16, F] block: K5 needs a stream whose keys its gid column holds.
- ``nscale``: the autograd of ``project_and_color`` alone w.r.t. (means,
  cov6, colour, opacity, sh) under the JAX tool's loss, sum(table *
  1e-6) over the 9 attribute columns the binning carries.

``--newtail`` reads ``reorder`` alone: the port's tail is the JAX
package's newer one (a sort, segment sums, an uncompact). ``--variants``
reads the JAX tool's five sub-pieces as torch ops at its sizes (1M
gaussians, ``--f-pad`` slots): a stable key sort with 9 payload gathers,
a stack of 9 (or 16) columns and its cumsum, and 2 gathers of [F, 9]
(or [F, 16]) rows.

    python -m wgpu_3dgs_core_tpu_torch.tools.bench_bwd \\
        [--newtail | --variants [--f-pad 3955712]] [bench arguments] \\
        [--iters 10] [--device cuda]

Prints a line per stage, then one JSON line naming the device
(``tools/stages.py``). Reads on a CUDA card only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.binning import num_tiles
from ..ops.rasterize import rasterize_tiles_bwd, tiles_to_image
from ..render.renderer import (
    attribute_columns,
    composite_tiles,
    project_and_color,
    reorder_grads,
)
from .stages import (
    BACKGROUND,
    CUTOFF_SQ,
    bench_parser,
    bench_setup,
    forward_prefix,
    read_stages,
    report,
    require_card,
)

# The JAX tool's --variants sizes: gaussians, slots (its BWD_F_PAD).
VARIANT_N = 1_000_000
VARIANT_F_PAD = 3_955_712


def tail_inputs(gather: dict, camera) -> dict:
    """The backward tail's inputs from a ``gather`` prefix's pieces
    (``tools/stages.py::forward_prefix``): its stream, schedule and
    per-gaussian table, and K4's gradients [9, F] under the cotangent the
    bench loss mean(image^2) sends its tiles, made by the same ops as in
    ``render`` so that it is that cotangent bit for bit."""
    stream, sched = gather["stream"], gather["sched"]
    tiles_x, tiles_y = num_tiles(camera.width, camera.height)
    with torch.enable_grad():
        tiles = gather["tiles"].detach().requires_grad_(True)
        img = tiles_to_image(
            composite_tiles(tiles, sched.tile_written, BACKGROUND),
            tiles_x, tiles_y, camera.width, camera.height)
        loss = torch.mean(img[..., 0:3] ** 2)
        (d_tiles,) = torch.autograd.grad(loss, tiles)
    with torch.no_grad():
        dfrag = rasterize_tiles_bwd(
            gather["frags"], stream.tile_start, sched.tile_len,
            sched.draw_len, gather["tiles"], d_tiles.contiguous(),
            BACKGROUND, CUTOFF_SQ, 0)
    return dict(dfrag=dfrag, gauss_id=stream.gauss_id,
                tile_id=stream.tile_id, tile_start=stream.tile_start,
                draw_len=sched.draw_len, tab_ints=gather["table"].ints,
                overflow=gather["overflow"])


@torch.no_grad()
def reorder(tail: dict) -> torch.Tensor:
    """The backward's tail on :func:`tail_inputs`: d attribute columns
    [9, N]."""
    return reorder_grads(**tail)


def nscale(params, camera, sh_deg: int) -> tuple:
    """Gradients w.r.t. the five ``params`` of sum(table * 1e-6) over the
    [9, N] attribute columns of ``project_and_color``, as the binning
    carries them."""
    means, cov6, color, opac, sh = params
    splats, rgb, opacity = project_and_color(means, cov6, color, opac,
                                             camera, sh=sh, sh_deg=sh_deg)
    table = attribute_columns(splats.xy, splats.conic, rgb, opacity,
                              splats.mask)
    return torch.autograd.grad(torch.sum(table * 1e-6), params)


def variant_stages(f_pad: int = VARIANT_F_PAD, n: int = VARIANT_N,
                   seed: int = 0, device="cuda") -> dict:
    """The JAX tool's sub-pieces of its reorder on random data drawn with
    numpy from ``seed``: sortonly, stack9+cs, stack16+cs, gath9, gath16."""
    rng = np.random.default_rng(seed)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cols = [on(rng.normal(size=f_pad).astype(np.float32)) for _ in range(9)]
    key = on(np.sort(rng.integers(0, n, f_pad)).astype(np.int32))
    counts = rng.integers(0, 9, n).astype(np.int64)
    offsets = np.cumsum(counts) - counts
    end = on(np.clip(offsets + counts - 1, 0, f_pad - 1))
    lo = on(np.clip(offsets - 1, 0, f_pad - 1))
    cs9 = on(rng.normal(size=(f_pad, 9)).astype(np.float32))
    cs16 = on(rng.normal(size=(f_pad, 16)).astype(np.float32))

    def sortonly():
        keys, perm = torch.sort(key, stable=True)
        return keys, [c[perm] for c in cols]

    def stack_cumsum(width):
        pad = [torch.zeros_like(cols[0])] * (width - len(cols))
        return torch.cumsum(torch.stack(cols + pad, dim=1), dim=0)

    return {
        "sortonly": sortonly,
        "stack9+cs": lambda: stack_cumsum(9),
        "stack16+cs": lambda: stack_cumsum(16),
        "gath9": lambda: cs9[end] - cs9[lo],
        "gath16": lambda: cs16[end] - cs16[lo],
    }


def stages(params, camera, max_fragments: int, max_rows: int,
           pad_slack: float, sh_deg: int) -> dict:
    """``reorder`` and ``nscale`` on ``params`` and ``camera``."""
    gather = forward_prefix(params, camera, max_fragments, max_rows,
                            pad_slack, sh_deg, "gather")
    tail = tail_inputs(gather, camera)
    del gather
    return {"reorder": lambda: reorder(tail),
            "nscale": lambda: nscale(params, camera, sh_deg)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = bench_parser(__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--newtail", action="store_true",
                      help="read the reorder alone")
    mode.add_argument("--variants", action="store_true",
                      help="read the reorder's sub-pieces on random data")
    ap.add_argument("--f-pad", type=int, default=VARIANT_F_PAD,
                    help="slots of --variants")
    args = ap.parse_args(argv)
    dev = require_card(args.device, "bench_bwd")
    if args.variants:
        todo = variant_stages(args.f_pad, device=dev)
    else:
        params, camera = bench_setup(args, dev)
        todo = stages(params, camera, args.max_fragments, args.max_rows,
                      args.pad_slack, args.sh_deg)
        if args.newtail:
            del todo["nscale"]
    return report("bench_bwd", dev, args, read_stages(todo, args.iters))


if __name__ == "__main__":
    main()
