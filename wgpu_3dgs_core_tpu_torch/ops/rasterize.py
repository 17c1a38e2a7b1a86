"""Tile rasterizer: kernels K3 (forward) and K4 (backward), with their
plain versions.

The counterpart of ``wgpu_3dgs_core_tpu.ops.rasterize``.
:func:`rasterize_tiles_fwd` (replaces ``_fwd_kernel``) blends each 16x16
tile front to back over its depth-ordered range of the tile-sorted stream
and composites the background; :func:`rasterize_tiles_bwd` (replaces
``_bwd_kernel``) turns the cotangent of that output into per-fragment
gradients. On CUDA tensors both launch ``csrc/rasterize.cu``; on CPU
tensors they run :func:`rasterize_tiles_fwd_plain` and
:func:`rasterize_tiles_bwd_plain`.

Stream layout: f32 [9, F] rows x, y (TILE-LOCAL: shifted by the owning
tile's pixel origin, as the JAX renderer does before its kernel, so dx/dy
round the same way), conic a/b/c, r, g, b, opacity. Output: [T, 4, 256],
RGB with T_final * background, then T_final; pixels row-major in a tile.
"""

from __future__ import annotations

import torch

from .binning import TILE_SIZE
from .cuda import CudaKernel, F, I, P, check, on_cpu

PIX = TILE_SIZE * TILE_SIZE  # 256 pixels per tile
FRAG_ROWS = 9

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
Q_CUTOFF = 9.0  # RADIUS_CUTOFF ** 2
ELLIPSE_RING = 0.64  # ELLIPSE mode draws q in [0.64 cutoff^2, cutoff^2]
# The plain version pads a batch of tiles to its longest tile; this bounds
# the (tile, fragment, pixel) elements of one batch.
PLAIN_BATCH_ELEMS = 1 << 24


def blend_weights(alpha_sorted: torch.Tensor, dim: int = 0):
    """Front-to-back weights from alphas in blend order along ``dim``.

    T_i = prod_{j<i} (1 - alpha_j); fragment i blends iff T_i > T_MIN,
    with weight alpha_i T_i. T_final is the product over the blended
    fragments (they are a prefix, T being monotone). Returns
    (weights, T_final) with ``dim`` reduced in the latter.
    """
    a = alpha_sorted.movedim(dim, 0)
    one_minus = 1.0 - a
    t_all = torch.cat(
        [torch.ones_like(a[:1]), torch.cumprod(one_minus, dim=0)], dim=0
    )
    t = t_all[:-1]
    blend = t > T_MIN
    w = a * t * blend
    k = blend.sum(dim=0)
    t_final = torch.gather(t_all, 0, k[None]).squeeze(0)
    return w.movedim(0, dim), t_final


def _frag_alpha(f, px, py, cutoff_sq, mode):
    """Per-(fragment, pixel) alpha and keep-mask; ``f`` [9, ..., 1]."""
    dx = px - f[0]
    dy = py - f[1]
    q = f[2] * (dx * dx) + 2.0 * f[3] * (dx * dy) + f[4] * (dy * dy)
    op = f[8]
    if mode == 1:
        alpha = torch.clamp_max(op, ALPHA_CLAMP).expand_as(q)
        ok = (q <= cutoff_sq) & (q >= cutoff_sq * ELLIPSE_RING)
    else:
        alpha = torch.clamp_max(op * torch.exp(-0.5 * q), ALPHA_CLAMP)
        ok = q <= cutoff_sq
    return alpha, ok & (alpha >= ALPHA_MIN)


def _tile_batches(tile_start, tile_len, tiles):
    """The plain versions' batches over ``tiles`` (int64 tile ids): yields
    (positions in ``tiles`` [B], valid [B, L], stream index [B, L]). Tiles
    go in order of length, so each batch pads to at most twice its
    shortest tile, and a batch's padded (tile, fragment, pixel) block
    stays within PLAIN_BATCH_ELEMS. Padding indexes slot 0."""
    dev = tile_start.device
    lens = tile_len[tiles].long()
    order = torch.sort(lens, stable=True).indices
    lens_host = lens[order].tolist()
    starts = tile_start[tiles[order]].long()
    lens = lens[order]
    i = 0
    while i < len(lens_host):
        j, l_max = i + 1, max(lens_host[i], 1)
        while j < len(lens_host):
            nxt = max(l_max, lens_host[j])
            if (nxt > 2 * max(lens_host[i], 1)
                    or (j + 1 - i) * nxt * PIX > PLAIN_BATCH_ELEMS):
                break
            j, l_max = j + 1, nxt
        k = torch.arange(l_max, device=dev)
        valid = k[None, :] < lens[i:j, None]  # [B, L]
        idx = torch.where(valid, starts[i:j, None] + k[None, :], 0)
        yield order[i:j], valid, idx
        i = j


def _blend_batch(f, valid, bgv, cutoff_sq, mode):
    """Plain K3 on one batch of tiles: ``f`` [9, B, L] fragments, ``valid``
    [B, L]. Returns [B, 4, P] (RGB + T_final * bg, then T_final)."""
    p = torch.arange(PIX, device=f.device)
    px = (p % TILE_SIZE).float() + 0.5
    py = torch.div(p, TILE_SIZE, rounding_mode="floor").float() + 0.5
    f = f[..., None]  # [9, B, L, 1]
    alpha, ok = _frag_alpha(f, px, py, cutoff_sq, mode)
    alpha = torch.where(ok & valid[..., None], alpha, 0.0)  # [B, L, P]
    w, t_final = blend_weights(alpha, dim=1)
    rgb = (w[:, None] * f[5:8].movedim(0, 1)).sum(dim=2)  # [B, 3, P]
    return torch.cat([rgb + t_final[:, None] * bgv, t_final[:, None]], dim=1)


def rasterize_tiles_fwd_plain(frags, tile_start, tile_len, bg,
                              cutoff_sq: float = Q_CUTOFF, mode: int = 0,
                              tiles=None) -> torch.Tensor:
    """Plain version of K3, optionally on a subset ``tiles`` (a sequence of
    tile ids; default all), in batches of tiles padded to their longest
    tile."""
    dev = frags.device
    n_t = tile_start.shape[0]
    tiles = (torch.arange(n_t, device=dev) if tiles is None
             else torch.as_tensor(tiles, dtype=torch.int64, device=dev))
    bgv = torch.tensor(bg, dtype=torch.float32, device=dev)[:, None]
    out = torch.empty((tiles.shape[0], 4, PIX), dtype=torch.float32,
                      device=dev)
    for b, valid, idx in _tile_batches(tile_start, tile_len, tiles):
        out[b] = _blend_batch(frags[:, idx], valid, bgv, cutoff_sq, mode)
    return out


RASTERIZE_FWD = CudaKernel(
    "rasterize_fwd", "gs_rasterize_fwd", [P, I, P, P, I, F, F, F, F, I, P],
)


def rasterize_tiles_fwd(frags, tile_start, tile_len, bg,
                        cutoff_sq: float = Q_CUTOFF,
                        mode: int = 0) -> torch.Tensor:
    """K3: rasterize every tile t from its ``tile_len[t]`` fragments at
    ``tile_start[t]`` of the stream ``frags`` [9, F]. Returns [T, 4, 256]
    f32; a tile with no fragments comes out as the background with T = 1.
    """
    n_t = tile_start.shape[0]
    check(frags, "frags", torch.float32, (FRAG_ROWS, None))
    check(tile_start, "tile_start", torch.int32, (n_t,))
    check(tile_len, "tile_len", torch.int32, (n_t,))
    if on_cpu(frags, tile_start, tile_len):
        return rasterize_tiles_fwd_plain(frags, tile_start, tile_len, bg,
                                         cutoff_sq, mode)
    dev = frags.device
    out = torch.empty((n_t, 4, PIX), dtype=torch.float32, device=dev)
    RASTERIZE_FWD.launch(
        frags.data_ptr(), frags.shape[1], tile_start.data_ptr(),
        tile_len.data_ptr(), n_t, float(bg[0]), float(bg[1]), float(bg[2]),
        float(cutoff_sq), int(mode), out.data_ptr(), work=n_t, device=dev,
    )
    return out


def rasterize_tiles_bwd_plain(frags, tile_start, tile_len, draw_len, out,
                              g_out, bg, cutoff_sq: float = Q_CUTOFF,
                              mode: int = 0) -> torch.Tensor:
    """Plain version of K4: ``torch.autograd.grad`` of the plain K3
    (:func:`rasterize_tiles_fwd_plain`'s batches, drawing ``draw_len``
    fragments of each tile) with respect to the fragments, against the
    cotangent ``g_out``. ``tile_len`` and K3's ``out`` are the kernel's
    arguments; autograd recomputes what it needs. Slots not drawn get
    zeros."""
    del tile_len, out  # the kernel's zero fill and pixel inputs
    dev = frags.device
    tiles = torch.arange(tile_start.shape[0], device=dev)
    bgv = torch.tensor(bg, dtype=torch.float32, device=dev)[:, None]
    dfrag = torch.zeros_like(frags)
    with torch.enable_grad():
        for b, valid, idx in _tile_batches(tile_start, draw_len, tiles):
            f = frags[:, idx].detach().requires_grad_(True)
            blk = _blend_batch(f, valid, bgv, cutoff_sq, mode)
            (d_f,) = torch.autograd.grad(blk, f, g_out[b])
            dfrag[:, idx[valid]] = d_f[:, valid]
    return dfrag


RASTERIZE_BWD = CudaKernel(
    "rasterize_bwd", "gs_rasterize_bwd",
    [P, I, P, P, P, I, P, P, F, F, F, F, I, P],
)


def rasterize_tiles_bwd(frags, tile_start, tile_len, draw_len, out, g_out,
                        bg, cutoff_sq: float = Q_CUTOFF,
                        mode: int = 0) -> torch.Tensor:
    """K4: per-fragment gradients [9, F] of the stream ``frags`` from K3's
    output ``out`` [T, 4, 256] and its cotangent ``g_out``.

    Tile t drew ``draw_len[t]`` of its ``tile_len[t]`` fragments at
    ``tile_start[t]`` (the tiles cover the stream's live prefix in order).
    Rows follow the stream's (x, y, conic a/b/c, r, g, b, opacity); every
    slot is written, and slots not drawn, drawn after their tile
    saturated, or past the live prefix are exact zeros.
    """
    n_t = tile_start.shape[0]
    check(frags, "frags", torch.float32, (FRAG_ROWS, None))
    for name, t in (("tile_start", tile_start), ("tile_len", tile_len),
                    ("draw_len", draw_len)):
        check(t, name, torch.int32, (n_t,))
    check(out, "out", torch.float32, (n_t, 4, PIX))
    check(g_out, "g_out", torch.float32, (n_t, 4, PIX))
    if on_cpu(frags, tile_start, tile_len, draw_len, out, g_out):
        return rasterize_tiles_bwd_plain(frags, tile_start, tile_len,
                                         draw_len, out, g_out, bg, cutoff_sq,
                                         mode)
    dev = frags.device
    dfrag = torch.empty_like(frags)
    RASTERIZE_BWD.launch(
        frags.data_ptr(), frags.shape[1], tile_start.data_ptr(),
        tile_len.data_ptr(), draw_len.data_ptr(), n_t, out.data_ptr(),
        g_out.data_ptr(), float(bg[0]), float(bg[1]), float(bg[2]),
        float(cutoff_sq), int(mode), dfrag.data_ptr(), work=n_t, device=dev,
    )
    return dfrag


def tiles_to_image(tiles: torch.Tensor, tiles_x: int, tiles_y: int,
                   width: int, height: int) -> torch.Tensor:
    """[T, C, 256] tile blocks -> [height, width, C] image crop."""
    c = tiles.shape[1]
    img = tiles.reshape(tiles_y, tiles_x, c, TILE_SIZE, TILE_SIZE)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        tiles_y * TILE_SIZE, tiles_x * TILE_SIZE, c
    )
    return img[:height, :width]
