"""The differentiable renderer: projection -> binning -> tiles -> image.

The counterpart of ``wgpu_3dgs_core_tpu.render.renderer``. :func:`render`
is the tensor-in/image-out function; :func:`render_gaussians` takes a
:class:`GaussiansBuffer` (or packed layout) plus the reference's
GaussianTransform/ModelTransform knobs. The forward runs the SH colour
kernel (ops/sh.py), K1, K2 and K14 (ops/expand.py, ops/binning.py) and K3
(ops/rasterize.py);
the backward of the binned rasterization (:class:`BinRasterize`, the
counterpart of the JAX ``custom_vjp``) runs K4 (ops/rasterize.py), a key
sort, K5 and K6 (ops/segreduce.py), and autograd carries the result
through the SH colour's backward kernel and the plain torch projection and
parameterization. Everything between the kernels is plain torch on the
inputs' device.

Each stage runs in a named scope (``utils/profiling.py``): ``render.unpack``,
``render.project``, ``render.bin``, ``render.raster``, and in the backward
``render.bin_bwd`` with ``render.reorder`` inside it. The binned
rasterization counts its stream's fragments, its capacity and its overflow
flag into the open counting session, if any.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..buffer import (
    GaussianDisplayMode,
    GaussiansBuffer,
    GaussianTransform,
    ModelTransform,
)
from ..layouts import Cov3dFormat, PackedGaussians
from ..ops.binning import (
    CHUNK,
    bin_splats_attrs,
    count_capacities,
    default_max_fragments,
    num_tiles,
    pad_schedule,
    padded_capacity,
    row_capacity,
)
from ..ops.expand import TAB_CNT
from ..ops.projection import camera_position, project
from ..ops.rasterize import (
    rasterize_tiles_bwd,
    rasterize_tiles_fwd,
    tiles_to_image,
)
from ..ops.segreduce import (
    gid_column_sorted,
    segment_sums_sorted,
    sort_keys,
    uncompact_columns,
)
from ..ops.sh import gaussian_color, sh_color
from ..ops.transforms import (
    device_constant,
    unpack_color,
    unpack_cov3d,
    unpack_sh,
)
from ..utils.profiling import count, named_scope
from .camera import Camera
from .reference import point_conic

# Measured capacities leave this much room over the counted stream, as in
# the JAX package: slack for the scene or camera drifting after the count.
CAPACITY_HEADROOM = 1.3


class RenderResult(NamedTuple):
    image: torch.Tensor  # [H, W, 3] f32
    transmittance: torch.Tensor  # [H, W] f32 final T per pixel
    overflow: torch.Tensor  # 0-d bool: a capacity was exceeded


def project_splats(
    means, cov3d_sigma6, opacity, camera, model_transform=None,
    size: float = 1.0, max_std_dev: float = 3.0,
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT,
    antialiased: bool = False,
):
    """The geometry :func:`render` bins: EWA projection (opacity-aware
    extents in SPLAT mode only), POINT mode's fixed conic and extent, and
    the opacity scaled by the antialias compensation. Returns (splats,
    opacity' [N])."""
    splats = project(
        means, cov3d_sigma6, camera, model_transform,
        size=size, radius_cutoff=max_std_dev, antialiased=antialiased,
        opacity=(
            opacity if display_mode == GaussianDisplayMode.SPLAT else None
        ),
    )
    opacity = opacity * splats.compensation
    if display_mode == GaussianDisplayMode.POINT:
        pt = max(float(size), 0.5)
        splats = splats._replace(
            conic=point_conic(size, cov3d_sigma6),
            extent=torch.where(
                splats.mask[:, None],
                float(math.ceil(np.float32(max_std_dev * pt))),
                torch.zeros_like(splats.extent),
            ),
        )
    return splats, opacity


def project_and_color(
    means, cov3d_sigma6, base_color, opacity, camera,
    sh=None, sh_deg: int = 0, no_sh0: bool = False,
    model_transform=None, size: float = 1.0, max_std_dev: float = 3.0,
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT,
    antialiased: bool = False,
):
    """Shared render prologue: :func:`project_splats` +
    :func:`view_color`. Returns (splats, rgb [N, 3], opacity' [N])."""
    splats, opacity = project_splats(
        means, cov3d_sigma6, opacity, camera, model_transform, size,
        max_std_dev, display_mode, antialiased,
    )
    return splats, view_color(means, base_color, camera, sh, sh_deg,
                              no_sh0), opacity


def view_color(means, base_color, camera, sh=None, sh_deg: int = 0,
               no_sh0: bool = False):
    """Each gaussian's colour [N, 3] seen from ``camera``: with SH,
    ``ops/sh.py::sh_color`` (the SH kernels on the card); without, the
    clamped base colour of ``gaussian_color``, which needs no direction."""
    if sh is not None and sh_deg >= 1:
        return sh_color(base_color, sh, means, camera_position(camera),
                        sh_deg, no_sh0)
    return gaussian_color(base_color, None, None, 0, no_sh0)


@torch.no_grad()
def measure_capacities(
    means, cov3d_sigma6, opacity, camera: Camera,
    model_transform: Optional[tuple] = None, size: float = 1.0,
    max_std_dev: float = 3.0,
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT,
    antialiased: bool = False, headroom: float = CAPACITY_HEADROOM,
) -> tuple[int, int]:
    """Measured (``max_fragments``, ``max_rows``) for a scene and camera:
    one projection pass as :func:`render` makes it for ``display_mode``,
    counting exactly the trimmed stream and row stream it bins (ELLIPSE
    bins its whole flat ring, without the opacity cull), times
    ``headroom``; fragments rounded up to 256 and rows to 512, each at
    least 1024. Syncs with the device."""
    tiles_x, tiles_y = num_tiles(camera.width, camera.height)
    splats, op = project_splats(
        means, cov3d_sigma6, opacity, camera, model_transform, size,
        max_std_dev, display_mode, antialiased,
    )
    rows, frags = count_capacities(
        splats.xy, splats.extent, splats.conic, op * splats.mask,
        splats.mask, tiles_x, tiles_y, cutoff_sq=float(max_std_dev) ** 2,
        opacity_cull=display_mode != GaussianDisplayMode.ELLIPSE,
    )

    def cap(total, align):
        c = max(int(int(total) * headroom), 1024)
        return -(-c // align) * align

    return cap(frags, 256), cap(rows, 512)


def measure_max_fragments(means, cov3d_sigma6, opacity, camera: Camera,
                          **kw) -> int:
    """The ``max_fragments`` of :func:`measure_capacities`."""
    return measure_capacities(means, cov3d_sigma6, opacity, camera, **kw)[0]


def measure_max_rows(means, cov3d_sigma6, opacity, camera: Camera,
                     **kw) -> int:
    """The ``max_rows`` (the K1 row-stream capacity) of
    :func:`measure_capacities`."""
    return measure_capacities(means, cov3d_sigma6, opacity, camera, **kw)[1]


def attribute_columns(xy, conic, rgb, opacity, mask):
    """The [9, N] attribute columns the binning carries to the rasterizer:
    x, y, conic a/b/c, r, g, b, and the opacity, zero for culled
    gaussians."""
    opac = opacity * mask  # culled gaussians contribute nothing
    return torch.cat([xy.T, conic.T, rgb.T, opac[None, :]], dim=0)


def composite_tiles(tiles, written, background: tuple):
    """K3's tiles where the schedule drew them, the background
    elsewhere."""
    bg_block = device_constant([*background, 1.0], tiles.device)
    return torch.where(written[:, None, None], tiles,
                       bg_block[None, :, None])


def reorder_grads(dfrag, gauss_id, tile_id, tile_start, draw_len, tab_ints,
                  overflow):
    """The backward's tail: K4's gradients [9, F] of the stream's slots as
    gradients [9, N] of the gaussians' attribute columns. One stable sort
    of the slots by gaussian (drawn slots only), K5's sums over the
    compacted gid column of the per-gaussian table's int rows
    ``tab_ints``, K6 back to gaussian order; all zero on overflow."""
    n = tab_ints.shape[1]
    keys, perm = sort_keys(gauss_id, tile_id, tile_start, draw_len, n)
    gid_col = gid_column_sorted(tab_ints, n)
    comp = segment_sums_sorted(keys, perm, dfrag, gid_col, n)
    d_cols = uncompact_columns(comp, gid_col, n)
    return torch.where(overflow, 0.0, d_cols)


class BinRasterize(torch.autograd.Function):
    """Binning + tiled rasterization, differentiable in ``attr_cols``.

    The counterpart of the JAX package's ``_bin_rasterize`` custom VJP.
    ``attr_cols`` [9, N]: x, y, conic a/b/c, r, g, b, opacity per
    gaussian. ``xy``, ``extent``, ``depth`` and ``mask`` only place the
    gaussians in tiles: they enter detached, and the gradient of ``xy``
    flows through ``attr_cols`` alone. Returns ([T, 4, 256] K3 tiles,
    [T] tile written, 0-d overflow); tiles not written are undefined and
    take no gradient.

    Forward: binning (K1, K2, K14), the padded schedule, K3. Backward: K4's
    per-fragment gradients, one sort of the slots by gaussian, K5's sums
    per gaussian and K6 back to gaussian order. On overflow the whole
    gradient is zero, as in the JAX package: the truncated stream's
    gradient would be an arbitrary subset.
    """

    @staticmethod
    def forward(ctx, attr_cols, xy, extent, depth, mask, tiles_x: int,
                tiles_y: int, f_cap: int, background: tuple,
                cutoff_sq: float, mode: int, pad_slack: float, max_rows):
        f_pad_cap = padded_capacity(f_cap, tiles_x * tiles_y, pad_slack)
        with named_scope("render.bin"):
            stream, frags, table = bin_splats_attrs(
                xy, extent, depth, mask, attr_cols, tiles_x, tiles_y, f_cap,
                max_rows=max_rows, cutoff_sq=cutoff_sq,
                opacity_cull=mode != 1,
            )
            sched = pad_schedule(stream, f_pad_cap)
            rows = table.ints[TAB_CNT].sum(dtype=torch.int32)
        with named_scope("render.raster"):
            tiles = rasterize_tiles_fwd(frags, stream.tile_start,
                                        sched.draw_len, background,
                                        cutoff_sq, mode)
        overflow = stream.overflow | sched.truncated
        count("fragments", stream.num_fragments)
        count("capacity", f_cap)
        count("overflow", overflow)
        count("rows", rows)
        count("row_capacity", row_capacity(
            f_cap if max_rows is None else max_rows))
        ctx.save_for_backward(frags, stream.gauss_id, stream.tile_id,
                              stream.tile_start, sched.tile_len,
                              sched.draw_len, table.ints, tiles, overflow)
        ctx.args = (background, cutoff_sq, mode)
        ctx.mark_non_differentiable(sched.tile_written, overflow)
        return tiles, sched.tile_written, overflow

    @staticmethod
    def backward(ctx, d_tiles, _written, _overflow):
        (frags, gauss_id, tile_id, tile_start, tile_len, draw_len, tab_ints,
         tiles, overflow) = ctx.saved_tensors
        background, cutoff_sq, mode = ctx.args
        with named_scope("render.bin_bwd"):
            dfrag = rasterize_tiles_bwd(frags, tile_start, tile_len,
                                        draw_len, tiles, d_tiles.contiguous(),
                                        background, cutoff_sq, mode)
            with named_scope("render.reorder"):
                d_cols = reorder_grads(dfrag, gauss_id, tile_id, tile_start,
                                       draw_len, tab_ints, overflow)
        return (d_cols,) + (None,) * 12


def rasterize_splats(xy, depth, conic, extent, mask, rgb, opacity,
                     tiles_x: int, tiles_y: int, f_cap: int,
                     background: tuple, cutoff_sq: float = 9.0, mode: int = 0,
                     pad_slack: float = 1.0, max_rows=None):
    """Projected splats -> ([tiles_x * tiles_y, 4, 256] tiles, overflow).

    Bins (K1, K2, K14), applies the JAX package's padded-schedule capacity
    (``pad_slack`` scales its per-tile padding headroom; truncation is
    folded into ``overflow``), rasterizes (K3), and composites tiles the
    schedule does not draw to the background. Differentiable in ``xy``,
    ``conic``, ``rgb`` and ``opacity`` (:class:`BinRasterize`).
    """
    with named_scope("render.bin"):
        attr_cols = attribute_columns(xy, conic, rgb, opacity, mask)
    tiles, written, overflow = BinRasterize.apply(
        attr_cols, xy.detach(), extent.detach(), depth.detach(), mask,
        tiles_x, tiles_y, f_cap, background, cutoff_sq, mode, pad_slack,
        max_rows,
    )
    with named_scope("render.raster"):
        return composite_tiles(tiles, written, background), overflow


def render(
    means: torch.Tensor,
    cov3d_sigma6: torch.Tensor,
    base_color: torch.Tensor,
    opacity: torch.Tensor,
    camera: Camera,
    sh: Optional[torch.Tensor] = None,
    sh_deg: int = 0,
    no_sh0: bool = False,
    background: tuple = (0.0, 0.0, 0.0),
    model_transform: Optional[tuple] = None,
    max_fragments: Optional[int] = None,
    size: float = 1.0,
    max_std_dev: float = 3.0,
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT,
    antialiased: bool = False,
    pad_slack: float = 1.0,
    max_rows: Optional[int] = None,
) -> RenderResult:
    """Tiled render to [H, W, 3] on the inputs' device, differentiable in
    ``means``, ``cov3d_sigma6``, ``base_color``, ``opacity`` and ``sh``.

    ``means`` [N,3], ``cov3d_sigma6`` [N,6], ``base_color`` [N,3] in [0,1],
    ``opacity`` [N] in [0,1], optional ``sh`` [N,15,3]; the other knobs as
    in the JAX package's ``render``. ``overflow`` is set when a capacity
    (``max_fragments``, ``max_rows``, or the padded schedule sized by
    ``pad_slack``) was exceeded and the image is missing fragments.
    """
    h, w_px = camera.height, camera.width
    tiles_x, tiles_y = num_tiles(w_px, h)
    n = means.shape[0]
    if max_fragments is None:
        max_fragments = default_max_fragments(n, tiles_x, tiles_y)
    f_cap = -(-max_fragments // CHUNK) * CHUNK  # whole blocks

    with named_scope("render.project"):
        splats, rgb, opacity = project_and_color(
            means, cov3d_sigma6, base_color, opacity, camera,
            sh=sh, sh_deg=sh_deg, no_sh0=no_sh0,
            model_transform=model_transform, size=size,
            max_std_dev=max_std_dev, display_mode=display_mode,
            antialiased=antialiased,
        )
    tiles, overflow = rasterize_splats(
        splats.xy, splats.depth, splats.conic, splats.extent, splats.mask,
        rgb, opacity, tiles_x, tiles_y, f_cap, tuple(background),
        cutoff_sq=float(max_std_dev) ** 2, mode=int(display_mode),
        pad_slack=pad_slack, max_rows=max_rows,
    )
    with named_scope("render.raster"):
        img = tiles_to_image(tiles, tiles_x, tiles_y, w_px, h)
    return RenderResult(
        image=img[..., 0:3],
        transmittance=img[..., 3],
        overflow=overflow,
    )


def unpack_gaussians(packed: PackedGaussians):
    """A packed layout of tensors -> the render arguments (means, cov3d
    sigma6, base color, opacity, sh or None), unpacked on its device."""
    layout = packed.layout
    cov3d6 = unpack_cov3d(packed.cov3d,
                          rot_scale=layout.cov3d == Cov3dFormat.ROT_SCALE)
    color = unpack_color(packed.color)
    sh = (None if packed.sh is None
          else unpack_sh(packed.sh, len(packed), packed.pos.device))
    return packed.pos, cov3d6, color[:, 0:3], color[:, 3], sh


def render_gaussians(
    gaussians: Any,
    camera: Camera,
    transform: GaussianTransform = GaussianTransform(),
    model_transform: Optional[ModelTransform] = None,
    background: tuple = (0.0, 0.0, 0.0),
    **kw,
) -> RenderResult:
    """Render a :class:`GaussiansBuffer` (or a :class:`PackedGaussians` of
    tensors), unpacking its layout on the device and honoring the
    reference's GaussianTransform knobs."""
    if isinstance(gaussians, GaussiansBuffer):
        packed = gaussians.data
    elif isinstance(gaussians, PackedGaussians):
        packed = gaussians
    else:
        raise TypeError(
            "render_gaussians expects a GaussiansBuffer or PackedGaussians; "
            "convert a GaussianSoA with GaussiansBuffer.new first"
        )
    with named_scope("render.unpack"):
        means, cov3d6, color, opacity, sh = unpack_gaussians(packed)
    # The model matrix enters the projection as Python floats.
    mt = (None if model_transform is None
          else model_transform.as_tensors("cpu"))
    return render(
        means=means,
        cov3d_sigma6=cov3d6,
        base_color=color,
        opacity=opacity,
        camera=camera,
        sh=sh,
        sh_deg=transform.sh_deg,
        no_sh0=transform.no_sh0,
        background=background,
        model_transform=mt,
        size=transform.size,
        max_std_dev=transform.max_std_dev,
        display_mode=transform.display_mode,
        **kw,
    )
