"""Tile rasterizer: kernels K3 (forward) and K4 (backward), with their
plain versions.

The counterpart of ``wgpu_3dgs_core_tpu.ops.rasterize``.
:func:`rasterize_tiles_fwd` (replaces ``_fwd_kernel``) blends each 16x16
tile front to back over its depth-ordered range of the tile-sorted stream
and composites the background; :func:`rasterize_tiles_bwd` (replaces
``_bwd_kernel``) turns the cotangent of that output into per-fragment
gradients. On CUDA tensors both launch ``csrc/rasterize.cu``; on CPU
tensors they run :func:`rasterize_tiles_fwd_plain` and
:func:`rasterize_tiles_bwd_plain`. Both kernels skip, a warp at a time,
the fragments whose conservative pixel box (:func:`frag_pixel_box_plain`,
``csrc/blend.cuh``'s ``frag_pixel_box``) misses the warp's pixels, which
changes no output: outside the box ``_frag_alpha`` rejects every pixel.

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


def _clamp_alpha(alpha_raw):
    """min(alpha_raw, ALPHA_CLAMP) with the gradient of the kernels and of
    the TPU kernel (its ``alpha_raw < ALPHA_CLAMP`` mask): 0 wherever the
    clamp is reached, a tie included (torch's ``clamp_max`` passes the
    whole gradient at a tie, ``jnp.minimum`` half)."""
    return torch.where(alpha_raw < ALPHA_CLAMP, alpha_raw,
                       torch.clamp_max(alpha_raw, ALPHA_CLAMP).detach())


def _frag_alpha(f, px, py, cutoff_sq, mode):
    """Per-(fragment, pixel) alpha and keep-mask; ``f`` [9, ..., 1]."""
    dx = px - f[0]
    dy = py - f[1]
    q = f[2] * (dx * dx) + 2.0 * f[3] * (dx * dy) + f[4] * (dy * dy)
    op = f[8]
    if mode == 1:
        alpha = _clamp_alpha(op).expand_as(q)
        ok = (q <= cutoff_sq) & (q >= cutoff_sq * ELLIPSE_RING)
    else:
        alpha = _clamp_alpha(op * torch.exp(-0.5 * q))
        ok = q <= cutoff_sq
    return alpha, ok & (alpha >= ALPHA_MIN)


# frag_pixel_box's constants (csrc/blend.cuh, where they are derived).
BOX_GAMMA = 5e-7
BOX_GAMMA_MAX = 0.5
BOX_REL = 1e-5
BOX_ABS = 1e-4
BOX_EMPTY = (16, 0)  # (lo, hi) of both axes of a box no pixel is in


def frag_pixel_box_plain(frags, cutoff_sq: float = Q_CUTOFF,
                         mode: int = 0) -> torch.Tensor:
    """The conservative pixel box of each fragment of ``frags`` [9, F], in
    f32 as ``csrc/blend.cuh::frag_pixel_box`` computes it: int32 [4, F]
    rows x_lo, x_hi, y_lo, y_hi, the tile-local pixel columns and rows
    outside which ``_frag_alpha`` rejects the fragment at every pixel
    centre. The whole tile [0, 15] x [0, 15] where the fragment's values
    are not finite or its conic is not positive definite or too thin to
    bound, ``BOX_EMPTY`` on both axes where no pixel can keep it."""
    f32 = frags.dtype

    def k(v):
        return torch.tensor(v, dtype=f32, device=frags.device)

    one, rel = k(1.0), k(BOX_REL)
    x, y, a, b, c, op = (frags[r] for r in (0, 1, 2, 3, 4, 8))
    finite = torch.stack([torch.isfinite(v) for v in (x, y, a, b, c, op)]
                         ).all(dim=0)
    if mode == 1:
        never = ~(op >= k(ALPHA_MIN))
        r = torch.full_like(op, cutoff_sq)
    else:
        never = ~(op > 0.0)
        la = k(2.0) * torch.log(op * k(255.0))
        r = torch.minimum(k(cutoff_sq), la + rel * (la.abs() + one))
    ac = a * c
    bb = b * b
    s = ac + bb
    det = (ac - bb) - k(4.0 * BOX_GAMMA) * s
    g = k(BOX_GAMMA) * k(2.0) * s / det * (one + rel)
    bounded = (a > 0.0) & (c > 0.0) & (det > 0.0) & (g <= k(BOX_GAMMA_MAX))
    rq = r / (one - g) * (one + rel)
    ex = torch.sqrt(rq * c / det) * (one + rel)
    ey = torch.sqrt(rq * a / det) * (one + rel)
    half = k(0.5)
    mx = rel * (x.abs() + ex) + k(BOX_ABS)
    my = rel * (y.abs() + ey) + k(BOX_ABS)
    lo_x = torch.clamp_min(torch.ceil(x - ex - half - mx), 0.0)
    hi_x = torch.clamp_max(torch.floor(x + ex - half + mx), 15.0)
    lo_y = torch.clamp_min(torch.ceil(y - ey - half - my), 0.0)
    hi_y = torch.clamp_max(torch.floor(y + ey - half + my), 15.0)
    meets = (lo_x <= hi_x) & (lo_y <= hi_y)
    full = ~finite | (~never & ~bounded)
    empty = ~full & (never | (r < 0.0) | ~meets)
    box = torch.stack([lo_x, hi_x, lo_y, hi_y])
    box = torch.where(full, torch.tensor([[0.0], [15.0], [0.0], [15.0]],
                                         dtype=f32, device=frags.device),
                      box)
    lo, hi = BOX_EMPTY
    box = torch.where(empty, torch.tensor([[lo], [hi], [lo], [hi]],
                                          dtype=f32, device=frags.device),
                      box)
    return box.to(torch.int32)


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


def check_fwd_args(frags, tile_start, tile_len):
    """Validate K3's tensor arguments (dtypes, shapes, layout)."""
    n_t = tile_start.shape[0]
    check(frags, "frags", torch.float32, (FRAG_ROWS, None))
    check(tile_start, "tile_start", torch.int32, (n_t,))
    check(tile_len, "tile_len", torch.int32, (n_t,))


def rasterize_tiles_fwd(frags, tile_start, tile_len, bg,
                        cutoff_sq: float = Q_CUTOFF,
                        mode: int = 0) -> torch.Tensor:
    """K3: rasterize every tile t from its ``tile_len[t]`` fragments at
    ``tile_start[t]`` of the stream ``frags`` [9, F]. Returns [T, 4, 256]
    f32; a tile with no fragments comes out as the background with T = 1.
    """
    check_fwd_args(frags, tile_start, tile_len)
    if on_cpu(frags, tile_start, tile_len):
        return rasterize_tiles_fwd_plain(frags, tile_start, tile_len, bg,
                                         cutoff_sq, mode)
    dev = frags.device
    n_t = tile_start.shape[0]
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


def check_bwd_args(frags, tile_start, tile_len, draw_len, out, g_out):
    """Validate K4's tensor arguments (dtypes, shapes, layout)."""
    n_t = tile_start.shape[0]
    check(frags, "frags", torch.float32, (FRAG_ROWS, None))
    for name, t in (("tile_start", tile_start), ("tile_len", tile_len),
                    ("draw_len", draw_len)):
        check(t, name, torch.int32, (n_t,))
    check(out, "out", torch.float32, (n_t, 4, PIX))
    check(g_out, "g_out", torch.float32, (n_t, 4, PIX))


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
    check_bwd_args(frags, tile_start, tile_len, draw_len, out, g_out)
    if on_cpu(frags, tile_start, tile_len, draw_len, out, g_out):
        return rasterize_tiles_bwd_plain(frags, tile_start, tile_len,
                                         draw_len, out, g_out, bg, cutoff_sq,
                                         mode)
    dev = frags.device
    n_t = tile_start.shape[0]
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
