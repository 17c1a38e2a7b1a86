"""The measurement kernels K9 and K10, with their plain versions.

K9 (:func:`rasterize_level`, replaces ``tools/bench_kernel_variants.py::
run_variant``) is K3 stripped level by level, and K10
(:func:`segment_sums_level`, replaces ``tools/bench_segsum.py::
run_variant``) K5 the same way. Their levels are instantiations of the
production kernels' own source (``csrc/rasterize_fwd.cuh``,
``csrc/segsum.cuh``), so the full level of each is the production kernel
compiled again: ``v6_full`` is K3 and ``s2_gather`` K5, bit for bit. On
CUDA tensors the wrappers launch ``csrc/variants.cu``; on CPU tensors they
run the plain versions. Each level writes a result that depends on all its
work; the tools that time them are ``tools/bench_kernel_variants.py`` and
``tools/bench_segsum.py``.

K9's levels take K3's arguments and give a [T, 4, 256] tile. Each warp
works on K3's 8x4 pixel block (:func:`warp_pixels`), and from v1_cull on
walks only the fragments whose pixel box (``ops/rasterize.py::
frag_pixel_box_plain``) meets it:

- ``v0_stage``: the batch staging and the boxes; every pixel sums the
  staged opacities;
- ``v1_cull``: the warp's walk, summing the walked opacities;
- ``v2_q``: q of each walked (pixel, fragment) pair, summed;
- ``v3_alpha``: the kept alphas, summed;
- ``v4_trans``: the T recurrence while T > 1e-4, no stop, no colour (K3's
  tile for black fragments);
- ``v5_color``: the colour, no stop (K3's tile);
- ``v6_full``: K3;
- ``v7_notrans``: ``v6_full`` with exp(-q/2) replaced by 1 - q/2.

v0-v3 write their sum in channel 0 (channels 1-3 zero). v0_stage also
writes each staged fragment's box word (:func:`box_rows` unpacks them), so
a check can cull the plain versions of v1-v3 by the card's own boxes.

K10's levels take K5's arguments and give [9, rows]: ``s0_prep`` (K5's
first kernel alone: the slot-major copy, the row map, the zeros),
``s1_scan`` (the scan over a copy already in key order,
:func:`level_operand`), ``s2_gather`` (K5) and ``s2_nostage`` (K5 reading
[9, F] through the permutation, with no staging copy).
"""

from __future__ import annotations

import torch

from .binning import TILE_SIZE
from .cuda import CudaKernel, F, I, P, check, on_cpu
from .rasterize import (
    ALPHA_CLAMP,
    ALPHA_MIN,
    PIX,
    Q_CUTOFF,
    _frag_alpha,
    _tile_batches,
    blend_weights,
    check_fwd_args,
    frag_pixel_box_plain,
    rasterize_tiles_fwd_plain,
)
from .segreduce import (
    GRAD_ROWS,
    check_segsum_args,
    segment_sums_sorted_plain,
)

# -------------------------------------------------------------------- K9

RASTER_LEVELS = ("v0_stage", "v1_cull", "v2_q", "v3_alpha", "v4_trans",
                 "v5_color", "v6_full", "v7_notrans")
RASTER_LEVEL = CudaKernel(
    "rasterize_variants", "gs_raster_level",
    [I, P, I, P, P, I, F, F, F, F, I, P, P],
)
BOX_SHIFTS = (0, 8, 16, 24)  # x_lo, x_hi, y_lo, y_hi bytes of a box word


def warp_pixels() -> torch.Tensor:
    """The row-major pixels of each warp's lanes in K3 and K4, int64
    [8, 32], as ``csrc/rasterize_fwd.cuh::pixel_of`` maps them: warp w on
    an 8x4 block, columns 8 (w % 2) .. + 7 and rows 4 (w // 2) .. + 3."""
    p = torch.arange(PIX)
    w, lane = p // 32, p % 32
    return (((w // 2) * 4 + lane // 8) * 16 + (w % 2) * 8 + lane % 8
            ).reshape(8, 32)


def box_rows(words: torch.Tensor) -> torch.Tensor:
    """Box words (int32 [F], ``csrc/blend.cuh::frag_pixel_box``'s packing)
    as int32 [4, F] rows x_lo, x_hi, y_lo, y_hi."""
    return torch.stack([(words >> s) & 0xFF for s in BOX_SHIFTS])


def box_words(rows: torch.Tensor) -> torch.Tensor:
    """:func:`box_rows` inverted: int32 [4, F] rows to box words [F]."""
    return rows[0] | (rows[1] << 8) | (rows[2] << 16) | (rows[3] << 24)


def _pixels(dev):
    p = torch.arange(PIX, device=dev)
    px = (p % TILE_SIZE).float() + 0.5
    py = torch.div(p, TILE_SIZE, rounding_mode="floor").float() + 0.5
    return px, py


def _warp_blocks(dev):
    """Each row-major pixel's warp block (x0, x1, y0, y1), int32 [4, 256]."""
    p = torch.arange(PIX, device=dev, dtype=torch.int32)
    x0 = (p % TILE_SIZE) // 8 * 8
    y0 = p // TILE_SIZE // 4 * 4
    return torch.stack([x0, x0 + 7, y0, y0 + 3])


def _q(f, px, py):
    dx = px - f[0]
    dy = py - f[1]
    return f[2] * (dx * dx) + 2.0 * f[3] * (dx * dy) + f[4] * (dy * dy)


def _alpha_notrans(f, px, py, cutoff_sq, mode):
    """``_frag_alpha`` with exp(-q/2) replaced by 1 - q/2 (v7_notrans)."""
    if mode == 1:  # no falloff to replace
        return _frag_alpha(f, px, py, cutoff_sq, mode)
    q = _q(f, px, py)
    alpha = torch.clamp_max(f[8] * (1.0 + (-0.5 * q)), ALPHA_CLAMP)
    return alpha, (q <= cutoff_sq) & (alpha >= ALPHA_MIN)


def staged_slots(tile_start, tile_len) -> torch.Tensor:
    """The stream slots of every tile's fragments, int64."""
    lens = tile_len.long()
    dev = lens.device
    tile_of = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev),
                                      lens)
    first = torch.cumsum(lens, 0) - lens
    return (tile_start.long()[tile_of]
            + torch.arange(int(lens.sum()), device=dev) - first[tile_of])


def rasterize_level_plain(name: str, frags, tile_start, tile_len, bg,
                          cutoff_sq: float = Q_CUTOFF, mode: int = 0,
                          cull_boxes=None) -> torch.Tensor:
    """Plain version of level ``name``: K3's plain version for v5 and v6
    (their tiles are K3's), with the colour rows zeroed for v4 and the
    falloff replaced for v7; the sums of v0-v3 in f64 over the kernel's
    f32 opacity, q and alpha, v1-v3 over the (pixel, fragment) pairs whose
    warp block the fragment's box meets. The boxes are the box words
    ``cull_boxes`` (int32 [F]: the card's, from v0_stage) or, when None,
    the plain mirror's (``frag_pixel_box_plain``)."""
    level = RASTER_LEVELS.index(name)
    if level in (5, 6):
        return rasterize_tiles_fwd_plain(frags, tile_start, tile_len, bg,
                                         cutoff_sq, mode)
    if level == 4:
        black = frags.clone()
        black[5:8] = 0.0
        return rasterize_tiles_fwd_plain(black, tile_start, tile_len, bg,
                                         cutoff_sq, mode)
    dev = frags.device
    n_t = tile_start.shape[0]
    px, py = _pixels(dev)
    out = torch.zeros((n_t, 4, PIX), dtype=torch.float32, device=dev)
    bgv = torch.tensor(bg, dtype=torch.float32, device=dev)[:, None]
    if level in (1, 2, 3):
        boxes = (frag_pixel_box_plain(frags, cutoff_sq, mode)
                 if cull_boxes is None else box_rows(cull_boxes))
        x0, x1, y0, y1 = _warp_blocks(dev)
    tiles = torch.arange(n_t, device=dev)
    for b, valid, idx in _tile_batches(tile_start, tile_len, tiles):
        f = frags[:, idx][..., None]  # [9, B, L, 1]
        if level == 7:
            alpha, ok = _alpha_notrans(f, px, py, cutoff_sq, mode)
            alpha = torch.where(ok & valid[..., None], alpha, 0.0)
            w, t_final = blend_weights(alpha, dim=1)
            rgb = (w[:, None] * f[5:8].movedim(0, 1)).sum(dim=2)
            out[b] = torch.cat([rgb + t_final[:, None] * bgv,
                                t_final[:, None]], dim=1)
            continue
        if level <= 1:
            val = f[8].expand(-1, -1, PIX)
        elif level == 2:
            val = _q(f, px, py)
        else:
            alpha, ok = _frag_alpha(f, px, py, cutoff_sq, mode)
            val = torch.where(ok, alpha, 0.0)
        keep = valid[..., None]
        if level >= 1:
            box = boxes[:, idx][..., None]  # [4, B, L, 1]
            keep = keep & ((box[0] <= x1) & (box[1] >= x0) & (box[2] <= y1)
                           & (box[3] >= y0))
        val = torch.where(keep, val.double(), 0.0)
        out[b, 0] = val.sum(dim=1).float()
    return out


def rasterize_level(name: str, frags, tile_start, tile_len, bg,
                    cutoff_sq: float = Q_CUTOFF, mode: int = 0, boxes=None):
    """K9 level ``name`` over K3's arguments. Returns [T, 4, 256] f32.
    v0_stage writes the box word of each fragment it stages into ``boxes``
    (int32 [F]; the slots of every tile, the others left as they were; a
    scratch buffer when None); the other levels leave it alone."""
    if name not in RASTER_LEVELS:
        raise ValueError(f"unknown level {name!r}; expected one of "
                         f"{RASTER_LEVELS}")
    check_fwd_args(frags, tile_start, tile_len)
    level = RASTER_LEVELS.index(name)
    if boxes is not None:
        check(boxes, "boxes", torch.int32, (frags.shape[1],))
    if on_cpu(frags, tile_start, tile_len):
        if level == 0 and boxes is not None:
            slots = staged_slots(tile_start, tile_len)
            boxes[slots] = box_words(frag_pixel_box_plain(
                frags[:, slots], cutoff_sq, mode))
        return rasterize_level_plain(name, frags, tile_start, tile_len, bg,
                                     cutoff_sq, mode)
    dev = frags.device
    n_t = tile_start.shape[0]
    out = torch.empty((n_t, 4, PIX), dtype=torch.float32, device=dev)
    if level == 0 and boxes is None:
        boxes = torch.empty(frags.shape[1], dtype=torch.int32, device=dev)
    RASTER_LEVEL.launch(
        level, frags.data_ptr(), frags.shape[1], tile_start.data_ptr(),
        tile_len.data_ptr(), n_t, float(bg[0]), float(bg[1]), float(bg[2]),
        float(cutoff_sq), int(mode), out.data_ptr(),
        boxes.data_ptr() if level == 0 else None, work=n_t, device=dev,
    )
    return out


# ------------------------------------------------------------------- K10

# K10's levels, as csrc/segsum.cuh numbers them; s2_gather is K5.
SEGSUM_LEVELS = ("s0_prep", "s1_scan", "s2_gather", "s2_nostage")
SEGSUM_LEVEL = CudaKernel(
    "segment_sum_variants", "gs_segsum_level",
    [I, P, P, P, I, P, I, I, P, P, P],
)


def level_operand(name: str, grad: torch.Tensor,
                  perm: torch.Tensor) -> torch.Tensor:
    """The gradient array level ``name`` reads: in key order
    (``grad[:, perm]``) for s1_scan, in slot order for the others."""
    return grad[:, perm].contiguous() if name == "s1_scan" else grad


def segment_sums_level_plain(name: str, keys, perm, grad, gid_col,
                             n: int) -> torch.Tensor:
    """Plain version of level ``name`` (``grad`` as :func:`level_operand`
    gives it): zeros for s0_prep (what K5's first kernel leaves in the
    output); K5's plain version over the key-ordered gradients for
    s1_scan; K5's plain version for the others."""
    if name == "s0_prep":
        return torch.zeros((GRAD_ROWS, gid_col.shape[0]),
                           dtype=torch.float32, device=grad.device)
    if name == "s1_scan":
        perm = torch.arange(keys.shape[0], device=grad.device)
    return segment_sums_sorted_plain(keys, perm, grad, gid_col, n)


def prep_plain(grad, gid_col, n: int, grad_t, row_of) -> None:
    """What K5's first kernel writes into its scratch: ``grad_t`` [F, 9] =
    ``grad.T`` (None: no staging copy, as in s2_nostage), and
    ``row_of[g]`` = the first row holding the live gid g (the other entries
    left as they were)."""
    if grad_t is not None:
        grad_t.copy_(grad.T)
    rows = torch.arange(gid_col.shape[0], device=gid_col.device,
                        dtype=torch.int32)
    first = torch.ones_like(gid_col, dtype=torch.bool)
    first[1:] = gid_col[1:] != gid_col[:-1]
    live = first & (gid_col < n)
    row_of[gid_col[live].long()] = rows[live]


def segment_sums_level(name: str, keys, perm, grad, gid_col, n: int,
                       scratch=None) -> torch.Tensor:
    """K10 level ``name`` over K5's arguments (``grad`` as
    :func:`level_operand` gives it). Returns [9, rows] f32. ``scratch``,
    (grad_t f32 [F, 9], row_of int32 [n]), is where the level's first
    kernel writes its staging copy (not s2_nostage) and row map
    (:func:`prep_plain`); scratch buffers when None."""
    if name not in SEGSUM_LEVELS:
        raise ValueError(f"unknown level {name!r}; expected one of "
                         f"{SEGSUM_LEVELS}")
    check_segsum_args(keys, perm, grad, gid_col)
    f, rows = keys.shape[0], gid_col.shape[0]
    dev = grad.device
    stage = name != "s2_nostage"
    if scratch is None:
        scratch = (torch.empty((f, GRAD_ROWS), dtype=torch.float32,
                               device=dev) if stage else None,
                   torch.empty(n, dtype=torch.int32, device=dev))
    grad_t, row_of = scratch
    if stage:
        check(grad_t, "grad_t", torch.float32, (f, GRAD_ROWS))
    check(row_of, "row_of", torch.int32, (n,))
    if on_cpu(keys, perm, grad, gid_col):
        if rows:
            prep_plain(grad, gid_col, n, grad_t if stage else None, row_of)
        return segment_sums_level_plain(name, keys, perm, grad, gid_col, n)
    out = torch.empty((GRAD_ROWS, rows), dtype=torch.float32, device=dev)
    SEGSUM_LEVEL.launch(
        SEGSUM_LEVELS.index(name), keys.data_ptr(), perm.data_ptr(),
        grad.data_ptr(), f, gid_col.data_ptr(), rows, n, out.data_ptr(),
        grad_t.data_ptr() if stage else None, row_of.data_ptr(), work=rows,
        device=dev,
    )
    return out

