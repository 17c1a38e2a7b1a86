"""Variant kernels of the measurement path: K9 (the forward rasterizer K3
stripped level by level), the first designs of K4, K7 and K8, and K10
(the segment sums of K5's first design, a warp per row, stripped level by
level), with their plain versions.

K9 (:func:`rasterize_level`, replaces ``tools/bench_kernel_variants.py::
run_variant``) and K10 (:func:`segment_sums_level`, replaces
``tools/bench_segsum.py::run_variant``) run the levels of
``csrc/variants.cu`` on CUDA tensors and their plain versions on CPU
tensors. Each level writes a result that depends on all its work; the
levels and what each adds are listed there and in the tools that time
them (``tools/bench_kernel_variants.py``, ``tools/bench_segsum.py``).

K9's levels take K3's arguments and give a [T, 4, 256] tile: v0_stage,
v1_q and v2_alpha their per-pixel sum in channel 0 (channels 1-3 zero);
v3_trans, v4_color and v6_notrans a K3 tile; v5_full, K3's first design
(no pixel-box cull), K3's tile bit for bit.
:func:`rasterize_bwd_first` runs K4's first design, before the cull and
the reduce-scatter, over K4's arguments; :func:`expand_fragments_first`
K7's, a binary search per slot over the whole table, over K7's; and
:func:`bundle_dispatch_first` K8's, one block a tile without overlap,
over a bundle's dispatch.
K10's levels take K5's arguments and give [9, rows]; s0_stream and
s1_search read the gradients in key order (:func:`level_operand`).
"""

from __future__ import annotations

import torch

from .binning import TILE_SIZE
from .cuda import CudaKernel, F, I, Launcher, P, check, on_cpu
from .expand import (
    SegmentTable,
    check_table,
    empty_tiles,
    expand_fragments_plain,
)
from .kernel_bundle import KernelBundle
from .rasterize import (
    ALPHA_CLAMP,
    ALPHA_MIN,
    FRAG_ROWS,
    PIX,
    Q_CUTOFF,
    _frag_alpha,
    _tile_batches,
    blend_weights,
    check_bwd_args,
    rasterize_tiles_bwd_plain,
    rasterize_tiles_fwd_plain,
)
from .segreduce import GRAD_ROWS, segment_sums_sorted_plain

# -------------------------------------------------------------------- K9

RASTER_LEVELS = ("v0_stage", "v1_q", "v2_alpha", "v3_trans", "v4_color",
                 "v5_full", "v6_notrans")
RASTER_LEVEL = CudaKernel(
    "rasterize_variants", "gs_raster_level",
    [I, P, I, P, P, I, F, F, F, F, I, P],
)


def _pixels(dev):
    p = torch.arange(PIX, device=dev)
    px = (p % TILE_SIZE).float() + 0.5
    py = torch.div(p, TILE_SIZE, rounding_mode="floor").float() + 0.5
    return px, py


def _q(f, px, py):
    dx = px - f[0]
    dy = py - f[1]
    return f[2] * (dx * dx) + 2.0 * f[3] * (dx * dy) + f[4] * (dy * dy)


def _alpha_notrans(f, px, py, cutoff_sq, mode):
    """``_frag_alpha`` with exp(-q/2) replaced by 1 - q/2 (level 6)."""
    if mode == 1:  # no falloff to replace
        return _frag_alpha(f, px, py, cutoff_sq, mode)
    q = _q(f, px, py)
    alpha = torch.clamp_max(f[8] * (1.0 + (-0.5 * q)), ALPHA_CLAMP)
    return alpha, (q <= cutoff_sq) & (alpha >= ALPHA_MIN)


def rasterize_level_plain(name: str, frags, tile_start, tile_len, bg,
                          cutoff_sq: float = Q_CUTOFF,
                          mode: int = 0) -> torch.Tensor:
    """Plain version of level ``name``: K3's plain version for v4 and v5
    (their tiles are K3's), with the colour rows zeroed for v3 and the
    falloff replaced for v6; the sums of v0-v2 in f64 over the kernel's
    f32 q and alpha."""
    level = RASTER_LEVELS.index(name)
    if level in (4, 5):
        return rasterize_tiles_fwd_plain(frags, tile_start, tile_len, bg,
                                         cutoff_sq, mode)
    if level == 3:
        black = frags.clone()
        black[5:8] = 0.0
        return rasterize_tiles_fwd_plain(black, tile_start, tile_len, bg,
                                         cutoff_sq, mode)
    dev = frags.device
    n_t = tile_start.shape[0]
    px, py = _pixels(dev)
    out = torch.zeros((n_t, 4, PIX), dtype=torch.float32, device=dev)
    bgv = torch.tensor(bg, dtype=torch.float32, device=dev)[:, None]
    tiles = torch.arange(n_t, device=dev)
    for b, valid, idx in _tile_batches(tile_start, tile_len, tiles):
        f = frags[:, idx][..., None]  # [9, B, L, 1]
        if level == 6:
            alpha, ok = _alpha_notrans(f, px, py, cutoff_sq, mode)
            alpha = torch.where(ok & valid[..., None], alpha, 0.0)
            w, t_final = blend_weights(alpha, dim=1)
            rgb = (w[:, None] * f[5:8].movedim(0, 1)).sum(dim=2)
            out[b] = torch.cat([rgb + t_final[:, None] * bgv,
                                t_final[:, None]], dim=1)
            continue
        if level == 0:
            val = f[8].expand(-1, -1, PIX)
        elif level == 1:
            val = _q(f, px, py)
        else:
            alpha, ok = _frag_alpha(f, px, py, cutoff_sq, mode)
            val = torch.where(ok, alpha, 0.0)
        val = torch.where(valid[..., None], val.double(), 0.0)
        out[b, 0] = val.sum(dim=1).float()
    return out


def rasterize_level(name: str, frags, tile_start, tile_len, bg,
                    cutoff_sq: float = Q_CUTOFF, mode: int = 0):
    """K9 level ``name`` over K3's arguments. Returns [T, 4, 256] f32."""
    if name not in RASTER_LEVELS:
        raise ValueError(f"unknown level {name!r}; expected one of "
                         f"{RASTER_LEVELS}")
    n_t = tile_start.shape[0]
    check(frags, "frags", torch.float32, (FRAG_ROWS, None))
    check(tile_start, "tile_start", torch.int32, (n_t,))
    check(tile_len, "tile_len", torch.int32, (n_t,))
    if on_cpu(frags, tile_start, tile_len):
        return rasterize_level_plain(name, frags, tile_start, tile_len, bg,
                                     cutoff_sq, mode)
    dev = frags.device
    out = torch.empty((n_t, 4, PIX), dtype=torch.float32, device=dev)
    RASTER_LEVEL.launch(
        RASTER_LEVELS.index(name), frags.data_ptr(), frags.shape[1],
        tile_start.data_ptr(), tile_len.data_ptr(), n_t, float(bg[0]),
        float(bg[1]), float(bg[2]), float(cutoff_sq), int(mode),
        out.data_ptr(), work=n_t, device=dev,
    )
    return out


# ------------------------------------------------- K4's first design

RASTERIZE_BWD_FIRST = CudaKernel(
    "rasterize_bwd_first", "gs_rasterize_bwd_first",
    [P, I, P, P, P, I, P, P, F, F, F, F, I, P],
)


def rasterize_bwd_first(frags, tile_start, tile_len, draw_len, out, g_out,
                        bg, cutoff_sq: float = Q_CUTOFF,
                        mode: int = 0) -> torch.Tensor:
    """K4's first design over K4's arguments (as
    ``ops/rasterize.py::rasterize_tiles_bwd`` takes them). Returns [9, F]
    f32; on CPU tensors K4's plain version."""
    check_bwd_args(frags, tile_start, tile_len, draw_len, out, g_out)
    if on_cpu(frags, tile_start, tile_len, draw_len, out, g_out):
        return rasterize_tiles_bwd_plain(frags, tile_start, tile_len,
                                         draw_len, out, g_out, bg, cutoff_sq,
                                         mode)
    dev = frags.device
    dfrag = torch.empty_like(frags)
    RASTERIZE_BWD_FIRST.launch(
        frags.data_ptr(), frags.shape[1], tile_start.data_ptr(),
        tile_len.data_ptr(), draw_len.data_ptr(), tile_start.shape[0],
        out.data_ptr(), g_out.data_ptr(), float(bg[0]), float(bg[1]),
        float(bg[2]), float(cutoff_sq), int(mode), dfrag.data_ptr(),
        work=tile_start.shape[0], device=dev,
    )
    return dfrag


# ------------------------------------------------- K7's first design

EXPAND_BBOX_FIRST = CudaKernel(
    "expand_fragments_bbox_first", "gs_expand_bbox_first",
    [P, I, P, I, I, I, P],
)


def expand_fragments_first(table: SegmentTable, total: torch.Tensor,
                           f_cap: int, tiles_x: int, t_total: int):
    """K7's first design (a binary search per slot over the whole table)
    over K7's arguments (as ``ops/expand.py::expand_fragments`` takes
    them). Returns (tile, gid) [f_cap] int32; on CPU tensors K7's plain
    version."""
    check_table(table, total)
    if on_cpu(table.ints, table.attrs, total):
        return expand_fragments_plain(table, total, f_cap, tiles_x, t_total)
    n = table.ints.shape[1]
    dev = table.ints.device
    if n == 0:
        return empty_tiles(f_cap, t_total, dev)
    out = torch.empty((2, f_cap), dtype=torch.int32, device=dev)
    EXPAND_BBOX_FIRST.launch(
        table.ints.data_ptr(), n, total.data_ptr(), f_cap, tiles_x, t_total,
        out.data_ptr(), work=f_cap, device=dev,
    )
    return out[0], out[1]


# ------------------------------------------------- K8's first design

KERNEL_BUNDLE_FIRST = Launcher("kernel_bundle_first")


def bundle_dispatch_first(bundle: KernelBundle, count: int,
                          resources=None):
    """A bundle's dispatch through K8's first design (a block per tile of
    ``block_size`` items, no overlap inside a block), on CUDA resources
    only: its outputs, as :meth:`KernelBundle.dispatch` returns them."""
    flat = bundle._flat(count, resources)
    if on_cpu(*flat):
        raise ValueError("K8's first design runs on CUDA tensors only")
    key = ("first", flat[0].device, tuple(t.dtype for t in flat))
    run = bundle._dispatch_cache.get(key)
    if run is None:
        run = bundle._dispatch_cache[key] = bundle._build_cuda(
            flat, first=True, launcher=KERNEL_BUNDLE_FIRST)
    result = tuple(run(count, flat))
    return result if len(result) > 1 else result[0]


# ------------------------------------------------------------------- K10

# name -> (level of csrc/variants.cu, threads per block)
SEGSUM_LEVELS = {
    "s0_stream": (0, 256),
    "s1_search": (1, 256),
    "s2_gather": (2, 256),
    "prod_b128": (2, 128),
    "prod_b512": (2, 512),
}
SEGSUM_LEVEL = CudaKernel(
    "segment_sum_variants", "gs_segsum_level",
    [I, I, P, P, P, I, P, I, I, P],
)


def level_operand(name: str, grad: torch.Tensor,
                  perm: torch.Tensor) -> torch.Tensor:
    """The gradient array level ``name`` reads: in key order
    (``grad[:, perm]``) for the levels without the gather, in slot order
    for the others."""
    return grad[:, perm].contiguous() if SEGSUM_LEVELS[name][0] < 2 else grad


def segment_sums_level_plain(name: str, keys, perm, grad, gid_col,
                             n: int) -> torch.Tensor:
    """Plain version of level ``name`` (``grad`` as :func:`level_operand`
    gives it): s0 as f64 sums of fixed runs; s1 as K5's plain version over
    the key-ordered gradients; the others as K5's plain version."""
    level = SEGSUM_LEVELS[name][0]
    f, rows = keys.shape[0], gid_col.shape[0]
    if level == 0:
        run = f // rows if rows else 0
        runs = grad[:, :run * rows].double().reshape(GRAD_ROWS, rows, run)
        return runs.sum(dim=2).float()
    if level == 1:
        perm = torch.arange(f, device=grad.device)
    return segment_sums_sorted_plain(keys, perm, grad, gid_col, n)


def segment_sums_level(name: str, keys, perm, grad, gid_col,
                       n: int) -> torch.Tensor:
    """K10 level ``name`` over K5's arguments (``grad`` as
    :func:`level_operand` gives it). Returns [9, rows] f32."""
    if name not in SEGSUM_LEVELS:
        raise ValueError(f"unknown level {name!r}; expected one of "
                         f"{tuple(SEGSUM_LEVELS)}")
    f, rows = keys.shape[0], gid_col.shape[0]
    check(keys, "keys", torch.int32, (f,))
    check(perm, "perm", torch.int64, (f,))
    check(grad, "grad", torch.float32, (GRAD_ROWS, f))
    check(gid_col, "gid_col", torch.int32, (rows,))
    if on_cpu(keys, perm, grad, gid_col):
        return segment_sums_level_plain(name, keys, perm, grad, gid_col, n)
    level, threads = SEGSUM_LEVELS[name]
    dev = grad.device
    out = torch.empty((GRAD_ROWS, rows), dtype=torch.float32, device=dev)
    SEGSUM_LEVEL.launch(
        level, threads, keys.data_ptr(), perm.data_ptr(), grad.data_ptr(), f,
        gid_col.data_ptr(), rows, n, out.data_ptr(), work=rows, device=dev,
    )
    return out
