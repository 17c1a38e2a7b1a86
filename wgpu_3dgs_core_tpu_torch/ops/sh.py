"""Real spherical-harmonics evaluation for view-dependent color.

The counterpart of ``wgpu_3dgs_core_tpu.ops.sh``, term for term. Band 0 is
baked into the IR's u8 color, so evaluation starts at band 1.

:func:`sh_color` is the renderer's SH colour of every gaussian seen from a
camera centre, forward and backward. On CUDA tensors it is one
``torch.autograd.Function`` whose forward and backward are each one kernel
of ``csrc/sh.cu``; on CPU tensors it is the plain graph,
:func:`gaussian_color` over :func:`view_dirs_from`. The kernel's forward
gives the plain graph's bits; :func:`sh_color_bwd_plain` is the closed form
its backward computes.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import count
from .cuda import CudaKernel, F, I, L, P, check, on_cpu
from .transforms import split_last

# Standard real SH constants (bands 1..3), as in the original 3DGS CUDA.
SH_C1 = 0.4886025119029199

SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)

SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, sh_deg: int) -> torch.Tensor:
    """Evaluate rest-band SH (bands 1..sh_deg) in unit directions.

    ``sh``: [..., 15, 3] rest coefficients; ``dirs``: [..., 3] unit view
    directions. Returns [..., 3] color deltas.
    """
    if sh_deg == 0:
        return torch.zeros_like(sh[..., 0, :])

    x = dirs[..., 0:1]
    y = dirs[..., 1:2]
    z = dirs[..., 2:3]

    result = SH_C1 * (-y * sh[..., 0, :] + z * sh[..., 1, :]
                      - x * sh[..., 2, :])

    if sh_deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = result + (
            SH_C2[0] * xy * sh[..., 3, :]
            + SH_C2[1] * yz * sh[..., 4, :]
            + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 5, :]
            + SH_C2[3] * xz * sh[..., 6, :]
            + SH_C2[4] * (xx - yy) * sh[..., 7, :]
        )

    if sh_deg >= 3:
        result = result + (
            SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 8, :]
            + SH_C3[1] * xy * z * sh[..., 9, :]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 10, :]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 11, :]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 12, :]
            + SH_C3[5] * z * (xx - yy) * sh[..., 13, :]
            + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 14, :]
        )

    return result


def gaussian_color(base_color: torch.Tensor, sh: torch.Tensor | None,
                   dirs: torch.Tensor | None, sh_deg: int,
                   no_sh0: bool = False) -> torch.Tensor:
    """Final RGB: band-0 base (or neutral 0.5 when ``no_sh0``) plus
    rest-band SH, clamped at 0 like the original 3DGS. ``dirs`` is read
    only with SH (``sh`` given and ``sh_deg`` >= 1)."""
    base = torch.full_like(base_color, 0.5) if no_sh0 else base_color
    if sh is None or sh_deg == 0:
        rgb = base
    else:
        rgb = base + eval_sh(sh, dirs, sh_deg)
    return torch.clamp_min(rgb, 0.0)


# ---------------------------------------------------------------- sh_color

# The norm clamp of the view directions (csrc/sh.cu's kNormEps).
NORM_EPS = 1e-12
SH_ROWS = 15  # rest-band coefficients a gaussian


def view_dirs_from(means: torch.Tensor, cam_pos) -> torch.Tensor:
    """Unit directions [N, 3] from the camera centre ``cam_pos`` (three
    floats) to each gaussian (``render/reference.py::view_dirs`` from a
    Camera)."""
    d = [m - c for m, c in zip(split_last(means), cam_pos)]
    norm = torch.clamp_min(torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]),
                           NORM_EPS)
    return torch.stack([di / norm for di in d], dim=-1)


def sh_color_plain(base, sh, means, cam_pos, sh_deg: int,
                   no_sh0: bool = False) -> torch.Tensor:
    """Plain version of :func:`sh_color`: the graph ``gaussian_color`` over
    ``view_dirs_from``, differentiable by autograd."""
    return gaussian_color(base, sh, view_dirs_from(means, cam_pos), sh_deg,
                          no_sh0)


def sh_basis(dirs: torch.Tensor, sh_deg: int):
    """Each rest-band coefficient's basis function at ``dirs`` [N, 3] and
    its gradient in the direction: ([N, 15], [N, 15, 3]), zeros for the
    coefficients above ``sh_deg``."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    zero = torch.zeros_like(x)
    rows = [  # (basis, d/dx, d/dy, d/dz)
        (-SH_C1 * y, zero, zero - SH_C1, zero),
        (SH_C1 * z, zero, zero, zero + SH_C1),
        (-SH_C1 * x, zero - SH_C1, zero, zero),
    ]
    if sh_deg >= 2:
        c0, c1, c2, c3, c4 = SH_C2
        rows += [
            (c0 * xy, c0 * y, c0 * x, zero),
            (c1 * yz, zero, c1 * z, c1 * y),
            (c2 * (2.0 * zz - xx - yy), -2.0 * c2 * x, -2.0 * c2 * y,
             4.0 * c2 * z),
            (c3 * xz, c3 * z, zero, c3 * x),
            (c4 * (xx - yy), 2.0 * c4 * x, -2.0 * c4 * y, zero),
        ]
    if sh_deg >= 3:
        c0, c1, c2, c3, c4, c5, c6 = SH_C3
        rows += [
            (c0 * y * (3.0 * xx - yy), c0 * 6.0 * xy, c0 * 3.0 * (xx - yy),
             zero),
            (c1 * xy * z, c1 * yz, c1 * xz, c1 * xy),
            (c2 * y * (4.0 * zz - xx - yy), c2 * -2.0 * xy,
             c2 * (4.0 * zz - xx - 3.0 * yy), c2 * 8.0 * yz),
            (c3 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), c3 * -6.0 * xz,
             c3 * -6.0 * yz, c3 * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
            (c4 * x * (4.0 * zz - xx - yy), c4 * (4.0 * zz - 3.0 * xx - yy),
             c4 * -2.0 * xy, c4 * 8.0 * xz),
            (c5 * z * (xx - yy), c5 * 2.0 * xz, c5 * -2.0 * yz,
             c5 * (xx - yy)),
            (c6 * x * (xx - 3.0 * yy), c6 * 3.0 * (xx - yy), c6 * -6.0 * xy,
             zero),
        ]
    rows += [(zero, zero, zero, zero)] * (SH_ROWS - len(rows))
    basis = torch.stack([r[0] for r in rows], dim=-1)
    grad = torch.stack([torch.stack(r[1:], dim=-1) for r in rows], dim=-2)
    return basis, grad


def sh_color_bwd_plain(base, sh, means, cam_pos, sh_deg: int, no_sh0: bool,
                       d_rgb):
    """The closed-form gradient of :func:`sh_color` that its backward
    kernel computes: (d_base, d_sh, d_means). The colour's gradient passes
    where the unclamped colour is >= 0 and the norm's where ``|d| >=
    NORM_EPS`` (torch's rules at both clamps); d_base is zeros under
    ``no_sh0``; d_sh is zeros in the rows above ``sh_deg``."""
    d = torch.stack([m - c for m, c in zip(split_last(means), cam_pos)], -1)
    norm = torch.sqrt((d * d).sum(-1, keepdim=True))
    nc = torch.clamp_min(norm, NORM_EPS)
    dirs = view_dirs_from(means, cam_pos)
    b = torch.full_like(base, 0.5) if no_sh0 else base
    gm = torch.where(b + eval_sh(sh, dirs, sh_deg) >= 0.0, d_rgb, 0.0)
    basis, grad = sh_basis(dirs, sh_deg)
    d_sh = basis[..., None] * gm[:, None, :]
    w = (sh * gm[:, None, :]).sum(-1)  # [N, 15]: each coefficient's weight
    d_dir = (w[..., None] * grad).sum(-2)
    radial = (d_dir * dirs).sum(-1, keepdim=True) * dirs
    d_means = torch.where(norm >= NORM_EPS, d_dir - radial, d_dir) / nc
    d_base = torch.zeros_like(gm) if no_sh0 else gm
    return d_base, d_sh, d_means


SH_COLOR_FWD = CudaKernel(
    "sh_color_fwd", "gs_sh_color_fwd",
    [P, L, L, P, L, L, P, I, I, F, F, F, I, P],
)
SH_COLOR_BWD = CudaKernel(
    "sh_color_bwd", "gs_sh_color_bwd",
    [P, L, L, P, L, L, P, P, L, L, I, I, F, F, F, I, P, P, P],
)


def _check_rows(t: torch.Tensor, name: str, n: int) -> None:
    """An [n, 3] float32 argument, read through its strides."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape) != (n, 3):
        raise ValueError(f"{name}: expected shape ({n}, 3), got "
                         f"{tuple(t.shape)}")


def _kernel_args(base, sh, means):
    """The arguments both kernels share, checked: (N, ``sh`` contiguous,
    which the caller keeps alive over the launch, the pointers and
    strides)."""
    n = means.shape[0]
    _check_rows(means, "means", n)
    _check_rows(base, "base", n)
    sh = sh.contiguous()
    check(sh, "sh", torch.float32, (n, SH_ROWS, 3))
    return n, sh, (means.data_ptr(), *means.stride(), base.data_ptr(),
                   *base.stride(), sh.data_ptr())


def sh_color_fwd(base, sh, means, cam_pos, sh_deg: int,
                 no_sh0: bool = False) -> torch.Tensor:
    """The forward kernel on CUDA tensors: rgb [N, 3], the bits of
    :func:`sh_color_plain`. ``cam_pos`` is three floats."""
    n, sh_c, args = _kernel_args(base, sh, means)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=means.device)
    SH_COLOR_FWD.launch(*args, n, sh_deg, *cam_pos, int(no_sh0),
                        rgb.data_ptr(), work=n, device=means.device)
    return rgb


def sh_color_bwd(base, sh, means, cam_pos, sh_deg: int, no_sh0: bool,
                 d_rgb):
    """The backward kernel on CUDA tensors: (d_base, d_sh, d_means), what
    :func:`sh_color_bwd_plain` computes."""
    n, sh_c, args = _kernel_args(base, sh, means)
    _check_rows(d_rgb, "d_rgb", n)
    dev = means.device
    d_base = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d_sh = torch.empty((n, SH_ROWS, 3), dtype=torch.float32, device=dev)
    d_means = torch.empty((n, 3), dtype=torch.float32, device=dev)
    SH_COLOR_BWD.launch(*args, d_rgb.data_ptr(), *d_rgb.stride(), n, sh_deg,
                        *cam_pos, int(no_sh0), d_base.data_ptr(),
                        d_sh.data_ptr(), d_means.data_ptr(), work=n,
                        device=dev)
    return d_base, d_sh, d_means


class _ShColor(torch.autograd.Function):
    """:func:`sh_color` on the card: the forward and the backward kernel.
    The backward builds no graph, so a second derivative raises."""

    @staticmethod
    def forward(ctx, base, sh, means, cam_pos, sh_deg, no_sh0):
        ctx.save_for_backward(base, sh, means)
        ctx.args = (cam_pos, sh_deg, no_sh0)
        return sh_color_fwd(base, sh, means, cam_pos, sh_deg, no_sh0)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_rgb):
        base, sh, means = ctx.saved_tensors
        cam_pos, sh_deg, no_sh0 = ctx.args
        d_base, d_sh, d_means = sh_color_bwd(base, sh, means, cam_pos,
                                             sh_deg, no_sh0, d_rgb)
        # Under no_sh0 the colour never reaches the image: no gradient, as
        # autograd gives through the plain graph.
        return (None if no_sh0 else d_base), d_sh, d_means, None, None, None


def sh_color(base, sh, means, cam_pos, sh_deg: int,
             no_sh0: bool = False) -> torch.Tensor:
    """The SH colour [N, 3] of each gaussian seen from the camera centre
    ``cam_pos`` (three floats): :func:`gaussian_color` of ``base`` [N, 3]
    and ``sh`` [N, 15, 3] in the unit directions from ``cam_pos`` to
    ``means`` [N, 3], differentiable in all three. ``sh_deg`` >= 1. On CPU
    tensors the plain graph; on CUDA tensors the kernels, each call
    counted as ``sh_color`` in the open counting session."""
    if sh_deg < 1:
        raise ValueError(f"sh_color needs sh_deg >= 1, got {sh_deg}")
    cam_pos = tuple(float(c) for c in cam_pos)
    if on_cpu(base, sh, means):
        return sh_color_plain(base, sh, means, cam_pos, sh_deg, no_sh0)
    count("sh_color", 1)
    return _ShColor.apply(base, sh, means, cam_pos, sh_deg, no_sh0)
