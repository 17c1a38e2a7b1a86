"""The plain reference renderer: projection, SH colour and a tiled blend.

Plain PyTorch, written from the blend rules of 3D Gaussian splatting as
the program under test states them, and importing nothing of that
program. Every number is computed in the dtype of the inputs (float32 for
the reference, bfloat16 for the control), with TF32 off.

Blend rules (frozen; the program's are the same by its documentation):

- EWA projection with a 0.3 pixel low-pass added to the 2D covariance;
  means outside ``near < z < far`` or with a non-positive 2D determinant
  are culled; the Jacobian is taken at the mean clamped to 1.3 times the
  half field of view.
- alpha = min(0.99, opacity * exp(-q / 2)), q the conic's quadratic form
  at the pixel centre (i + 0.5, j + 0.5); alpha's gradient is 0 where
  the clamp holds.
- A (pixel, gaussian) pair is kept iff q <= 9 (three standard
  deviations) and alpha >= 1/255.
- Front to back by camera depth (ties by gaussian index), the depth
  summed in the order ``camera_points`` gives; T_0 = 1,
  T_{i+1} = T_i (1 - alpha_i); kept pair i blends iff T_i > 1e-4, with
  weight alpha_i T_i; the pixel's transmittance is the product over the
  blended pairs, and its colour the weighted sum plus that times the
  background.

The blend runs tile by tile (16 x 16 pixels): a gaussian is listed in
every tile that a conservative box around its kept region meets, and
each group of tiles is evaluated densely, every listed gaussian at every
pixel of its tile. Listing too many changes nothing (an unkept pair
weighs 0), so the box only has to hold every kept pair.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

TILE = 16
PIX = TILE * TILE
ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
CUTOFF_SQ = 9.0
COV2D_BLUR = 0.3
FRUSTUM_MARGIN = 1.3
# Elements (tiles x listed gaussians x pixels) of one dense group.
GROUP_ELEMS = 1 << 25

SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def plain_precision() -> None:
    """TF32 off, so a float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class View:
    """A pinhole camera: ``view`` the 4x4 float32 world-to-camera matrix
    (camera z is depth), focal lengths in pixels, the image size and the
    clip depths. The principal point is the image centre."""

    view: np.ndarray
    fx: float
    fy: float
    width: int
    height: int
    near: float = 0.01
    far: float = 1000.0


def quat_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions [N, 4] (x, y, z, w) -> rotations [N, 3, 3]."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(*q.shape[:-1], 3, 3)


def covariance(q_unit: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Sigma = R diag(s)^2 R^T as [N, 3, 3]."""
    m = quat_rot(q_unit) * scale[..., None, :]
    return m @ m.transpose(-1, -2)


def sigma6(sigma: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] -> the upper triangle (xx, xy, xz, yy, yz, zz)."""
    i = torch.tensor([0, 0, 0, 1, 1, 2], device=sigma.device)
    j = torch.tensor([0, 1, 2, 1, 2, 2], device=sigma.device)
    return sigma[:, i, j]


def full_sigma(s6: torch.Tensor) -> torch.Tensor:
    xx, xy, xz, yy, yz, zz = s6.unbind(-1)
    return torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz],
                       dim=-1).reshape(-1, 3, 3)


def camera_points(means: torch.Tensor, cam: View) -> torch.Tensor:
    """Camera-space points [N, 3]: each row of the float32 view matrix
    times the mean, summed in index order, plus the translation. The
    order is part of the rules: in a dense scene neighbouring depths lie
    within a float32 step of each other, and the blend order follows the
    rounded depth (ties by index)."""
    v = np.asarray(cam.view, np.float32).tolist()
    x, y, z = means.unbind(-1)
    return torch.stack([x * v[j][0] + y * v[j][1] + z * v[j][2] + v[j][3]
                        for j in range(3)], dim=-1)


def project(means: torch.Tensor, sigma: torch.Tensor, cam: View):
    """EWA projection. ``sigma`` [N, 3, 3]. Returns (xy [N, 2], depth [N],
    conic [N, 3] = (a, b, c) of q = a dx^2 + 2 b dx dy + c dy^2,
    valid [N] bool)."""
    dt = means.dtype
    view = torch.as_tensor(np.asarray(cam.view, np.float32),
                           device=means.device).to(dt)
    rot = view[:3, :3]
    p = camera_points(means, cam)
    tz = p[:, 2]
    tz_safe = torch.where(tz > cam.near, tz, torch.full_like(tz, cam.near))
    lim_x = FRUSTUM_MARGIN * cam.width / (2.0 * cam.fx)
    lim_y = FRUSTUM_MARGIN * cam.height / (2.0 * cam.fy)
    tx = torch.clamp(p[:, 0] / tz_safe, -lim_x, lim_x)
    ty = torch.clamp(p[:, 1] / tz_safe, -lim_y, lim_y)
    zero = torch.zeros_like(tz)
    jac = torch.stack([cam.fx / tz_safe, zero, -cam.fx * tx / tz_safe,
                       zero, cam.fy / tz_safe, -cam.fy * ty / tz_safe],
                      dim=-1).reshape(-1, 2, 3)
    t = jac @ rot
    cov = t @ sigma @ t.transpose(-1, -2)
    c00 = cov[:, 0, 0] + COV2D_BLUR
    c01 = cov[:, 0, 1]
    c11 = cov[:, 1, 1] + COV2D_BLUR
    det = c00 * c11 - c01 * c01
    valid = (tz > cam.near) & (tz < cam.far) & (det > 0)
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c11 / det_safe, -c01 / det_safe, c00 / det_safe],
                        dim=-1)
    xy = torch.stack([cam.fx * p[:, 0] / tz_safe + cam.width / 2.0,
                      cam.fy * p[:, 1] / tz_safe + cam.height / 2.0],
                     dim=-1)
    return xy, tz, conic, valid


def camera_centre(cam: View, device, dtype) -> torch.Tensor:
    view = torch.as_tensor(np.asarray(cam.view, np.float32),
                           device=device).to(dtype)
    return -(view[:3, :3].T @ view[:3, 3])


def sh_colour(base: torch.Tensor, sh: torch.Tensor, means: torch.Tensor,
              cam: View) -> torch.Tensor:
    """base [N, 3] + real SH bands 1-3 of ``sh`` [N, 15, 3] in the unit
    direction from the camera centre to each mean, clamped at 0."""
    d = means - camera_centre(cam, means.device, means.dtype)
    d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1,
                                                     keepdim=True), 1e-12)
    x, y, z = (d[:, i:i + 1] for i in range(3))
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * xz, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy),
    ]
    rest = (torch.cat(basis, dim=-1)[:, :, None] * sh).sum(dim=1)
    return torch.clamp_min(base + rest, 0.0)


def splat_columns(means, sigma, base, opacity, sh, cam: View):
    """The per-gaussian columns the blend reads, [N, 9]: x, y, conic a,
    b, c, r, g, b, opacity (0 where culled); and (depth, valid)."""
    xy, depth, conic, valid = project(means, sigma, cam)
    rgb = sh_colour(base, sh, means, cam)
    op = opacity * valid.to(opacity.dtype)
    return torch.cat([xy, conic, rgb, op[:, None]], dim=-1), depth, valid


@dataclass
class Binned:
    """Gaussians listed per tile, front to back: ``gid`` [F] gaussian of
    each listed slot, ``start``/``length`` [T] each tile's run, and the
    host's plan of dense groups: (tile ids, longest run) each."""

    gid: torch.Tensor
    start: torch.Tensor
    length: torch.Tensor
    groups: list
    tiles_x: int
    tiles_y: int


def tiles_of(width: int, height: int) -> tuple[int, int]:
    return -(-width // TILE), -(-height // TILE)


def bin_tiles(cols: torch.Tensor, depth: torch.Tensor, valid: torch.Tensor,
              width: int, height: int,
              group_elems: int = GROUP_ELEMS) -> Binned:
    """List each gaussian in every tile that a box around its kept region
    meets. The box holds every pixel centre with q <= R, R = min(9,
    2 ln(255 opacity)) (beyond it alpha < 1/255), widened by 0.1% and a
    pixel, so that no rounding of q or of the box drops a kept pair."""
    with torch.no_grad():
        c = cols.detach().float()
        x, y, a, b, cc, op = c[:, 0], c[:, 1], c[:, 2], c[:, 3], c[:, 4], c[:, 8]
        det = a * cc - b * b
        ok = (valid & (op >= ALPHA_MIN) & (a > 0) & (cc > 0) & (det > 0)
              & torch.isfinite(c).all(dim=-1))
        idx = torch.nonzero(ok).squeeze(1)
        x, y, a, b, cc, op, det = (v[idx] for v in (x, y, a, b, cc, op, det))
        r = torch.clamp(torch.minimum(torch.full_like(op, CUTOFF_SQ),
                                      2.0 * torch.log(255.0 * op)), min=0.0)
        r = r * 1.001 + 1e-3
        hx = torch.sqrt(r * cc / det) + 1.0
        hy = torch.sqrt(r * a / det) + 1.0
        tiles_x, tiles_y = tiles_of(width, height)
        # Pixel centres i + 0.5 in [x - hx, x + hx].
        px0 = torch.clamp(torch.ceil(x - hx - 0.5), min=0)
        px1 = torch.clamp(torch.floor(x + hx - 0.5), max=width - 1)
        py0 = torch.clamp(torch.ceil(y - hy - 0.5), min=0)
        py1 = torch.clamp(torch.floor(y + hy - 0.5), max=height - 1)
        hit = (px0 <= px1) & (py0 <= py1)
        idx, px0, px1, py0, py1 = (v[hit] for v in (idx, px0, px1, py0, py1))
        tx0 = torch.div(px0.long(), TILE, rounding_mode="floor")
        tx1 = torch.div(px1.long(), TILE, rounding_mode="floor")
        ty0 = torch.div(py0.long(), TILE, rounding_mode="floor")
        ty1 = torch.div(py1.long(), TILE, rounding_mode="floor")
        nx = tx1 - tx0 + 1
        cnt = nx * (ty1 - ty0 + 1)
        # Front to back: each listed gaussian's rank by depth, ties by id.
        order = torch.sort(depth.detach()[idx].float(), stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=order.device)
        own = torch.repeat_interleave(torch.arange(idx.numel(),
                                                   device=idx.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(own.numel(), device=own.device) - first[own]
        tile = ((ty0[own] + torch.div(k, nx[own], rounding_mode="floor"))
                * tiles_x + tx0[own] + torch.remainder(k, nx[own]))
        key = tile * max(idx.numel(), 1) + rank[own]
        key, perm = torch.sort(key)
        gid = idx[own[perm]]
        n_tiles = tiles_x * tiles_y
        length = torch.bincount(tile[perm], minlength=n_tiles)
        start = torch.cumsum(length, 0) - length
        lens = length.cpu().numpy()
    order = np.argsort(-lens, kind="stable")
    groups, i = [], 0
    while i < len(order) and lens[order[i]] > 0:
        longest = int(lens[order[i]])
        take = max(1, group_elems // (longest * PIX))
        block = order[i:i + take]
        block = block[lens[block] > 0]
        groups.append((torch.as_tensor(block, device=cols.device), longest))
        i += take
    return Binned(gid, start, length, groups, tiles_x, tiles_y)


def _blend_group(cols, binned: Binned, tiles, longest, width, height):
    """Dense blend of one group of tiles: (rgb [G, 256, 3], transmittance
    [G, 256], kept [G, L, 256], blended [G, L, 256], listed gid [G, L],
    in-image pixels [G, 256]). Differentiable in ``cols``."""
    dev = cols.device
    ar = torch.arange(longest, device=dev)
    start = binned.start[tiles]
    live = ar[None, :] < binned.length[tiles][:, None]
    slot = torch.clamp(start[:, None] + ar[None, :], max=binned.gid.numel() - 1)
    gid = binned.gid[slot]
    f = cols[gid]  # [G, L, 9]
    p = torch.arange(PIX, device=dev)
    tx = torch.remainder(tiles, binned.tiles_x) * TILE
    ty = torch.div(tiles, binned.tiles_x, rounding_mode="floor") * TILE
    pxi = tx[:, None] + torch.remainder(p, TILE)[None, :]
    pyi = ty[:, None] + torch.div(p, TILE, rounding_mode="floor")[None, :]
    inside = (pxi < width) & (pyi < height)
    px = (pxi.to(cols.dtype) + 0.5)[:, None, :]
    py = (pyi.to(cols.dtype) + 0.5)[:, None, :]
    dx = px - f[..., 0:1]
    dy = py - f[..., 1:2]
    q = (f[..., 2:3] * (dx * dx) + 2.0 * f[..., 3:4] * (dx * dy)
         + f[..., 4:5] * (dy * dy))
    raw = f[..., 8:9] * torch.exp(-0.5 * q)
    alpha = torch.where(raw < ALPHA_CLAMP, raw,
                        torch.full_like(raw, ALPHA_CLAMP))
    kept = (q <= CUTOFF_SQ) & (alpha >= ALPHA_MIN) & live[..., None]
    alpha = torch.where(kept, alpha, torch.zeros_like(alpha))
    one_m = 1.0 - alpha
    prod = torch.cumprod(one_m, dim=1)
    t_before = torch.cat([torch.ones_like(prod[:, :1]), prod[:, :-1]], dim=1)
    blended = kept & (t_before > T_MIN)
    w = torch.where(blended, alpha * t_before, torch.zeros_like(alpha))
    rgb = torch.bmm(w.transpose(1, 2), f[..., 5:8])
    trans = torch.prod(torch.where(blended, one_m, torch.ones_like(one_m)),
                       dim=1)
    return rgb, trans, kept, blended, gid, inside


def _assemble(tile_vals, binned: Binned, width, height):
    """[T, 256, C] tiles -> [H, W, C] image."""
    c = tile_vals.shape[-1]
    img = tile_vals.reshape(binned.tiles_y, binned.tiles_x, TILE, TILE, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(binned.tiles_y * TILE,
                                             binned.tiles_x * TILE, c)
    return img[:height, :width]


def _to_tiles(img, binned: Binned):
    """[H, W, C] -> [T, 256, C], zero beyond the image."""
    h, w, c = img.shape
    pad = img.new_zeros(binned.tiles_y * TILE, binned.tiles_x * TILE, c)
    pad[:h, :w] = img
    return pad.reshape(binned.tiles_y, TILE, binned.tiles_x, TILE, c
                       ).permute(0, 2, 1, 3, 4).reshape(-1, PIX, c)


@dataclass
class Counts:
    """Work of one frame as the blend rules need it, from the inputs:
    ``gaussians`` N; ``visible`` splats that pass projection; ``used``
    gaussians with a kept pair; ``fragments`` (gaussian, tile) pairs with
    a kept pair in the tile; ``blended`` (pixel, gaussian) pairs blended
    before the pixel's termination; ``pixels``."""

    gaussians: int
    visible: int
    used: int
    fragments: int
    blended: int
    pixels: int


def render(cols, depth, valid, width, height, background=(0.0, 0.0, 0.0),
           counts: bool = False, group_elems: int = GROUP_ELEMS):
    """(image [H, W, 3], transmittance [H, W], Counts or None), no
    gradient."""
    with torch.no_grad():
        binned = bin_tiles(cols, depth, valid, width, height, group_elems)
        n_tiles = binned.tiles_x * binned.tiles_y
        out = cols.new_zeros(n_tiles, PIX, 4)
        out[..., 3] = 1.0
        n_frag = n_blend = 0
        used = torch.zeros(cols.shape[0], dtype=torch.bool,
                           device=cols.device)
        for tiles, longest in binned.groups:
            rgb, trans, kept, blended, gid, inside = _blend_group(
                cols, binned, tiles, longest, width, height)
            out[tiles, :, 0:3] = rgb
            out[tiles, :, 3] = trans
            if counts:
                kept = kept & inside[:, None, :]
                hit = kept.any(dim=2)
                n_frag += int(hit.sum())
                n_blend += int((blended & inside[:, None, :]).sum())
                used[gid[hit]] = True
        bg = torch.tensor([*background, 0.0], dtype=cols.dtype,
                          device=cols.device)
        out = out + out[..., 3:4] * bg
        img = _assemble(out, binned, width, height)
        c = None
        if counts:
            c = Counts(gaussians=cols.shape[0], visible=int(valid.sum()),
                       used=int(used.sum()), fragments=n_frag,
                       blended=n_blend, pixels=width * height)
    return img[..., 0:3], img[..., 3], c


def loss_and_grad(cols, depth, valid, width, height, target,
                  group_elems: int = GROUP_ELEMS, keep_rows=None):
    """mean((image - target)^2) over [H, W, 3] on a black background, and
    its gradient with respect to ``cols`` [N, 9], group by group.
    ``keep_rows`` (rows of the image the loss reads, the mean taken over
    them) serves the control's planted faults alone."""
    binned = bin_tiles(cols, depth, valid, width, height, group_elems)
    leaf = cols.detach().requires_grad_(True)
    tgt = _to_tiles(target.to(cols.dtype), binned)
    rows = height if keep_rows is None else keep_rows
    scale = 1.0 / (rows * width * 3)
    total = torch.zeros((), dtype=torch.float64, device=cols.device)
    for tiles, longest in binned.groups:
        rgb, _, _, _, _, inside = _blend_group(leaf, binned, tiles, longest,
                                               width, height)
        if keep_rows is not None:
            py = (torch.div(tiles, binned.tiles_x, rounding_mode="floor")
                  * TILE)[:, None] + torch.div(
                torch.arange(PIX, device=cols.device), TILE,
                rounding_mode="floor")[None, :]
            inside = inside & (py < keep_rows)
        err = torch.where(inside[..., None], rgb - tgt[tiles],
                          torch.zeros_like(rgb))
        part = (err * err).sum() * scale
        part.backward()
        total += part.detach().double()
    # Tiles with no listed gaussian are black: their error is the target.
    empty = binned.length == 0
    if bool(empty.any()):
        t_empty = tgt[empty]
        if keep_rows is not None:
            tiles = torch.nonzero(empty).squeeze(1)
            py = (torch.div(tiles, binned.tiles_x, rounding_mode="floor")
                  * TILE)[:, None] + torch.div(
                torch.arange(PIX, device=cols.device), TILE,
                rounding_mode="floor")[None, :]
            t_empty = torch.where((py < keep_rows)[..., None], t_empty,
                                  torch.zeros_like(t_empty))
        total += ((t_empty.double() ** 2).sum() * scale)
    grad = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
    return total, grad

