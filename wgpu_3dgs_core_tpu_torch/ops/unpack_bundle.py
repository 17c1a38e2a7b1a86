"""Unpack a GaussiansBuffer through a kernel bundle: the core layer's
compute path.

The reference crate builds its compute bundles on its WESL shader library
(src/shader/gaussian.wesl, model_transform.wesl); the JAX package's test of
the same path runs ``unpack_cov3d`` inside a bundle-dispatched Pallas
kernel (tests/test_kernel_bundle.py). :data:`UNPACK_GAUSSIANS` is that
path's kernel in the port: specialised by the buffer's layout
(``layout_config``), it reads pos, color, sh and cov3d through
``csrc/gaussian.cuh`` and writes, per gaussian, the world position under a
model transform f32[4] (homogeneous, w = 1), rgba f32[4], sh f32[45] and
sigma6 f32[6]. Its
plain version, :func:`unpack_plain`, is the port's ``unpack_*`` and
``model_to_world``, which the kernel equals bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..buffer import GaussiansBuffer, ModelTransform
from ..layouts import Cov3dFormat, GaussianLayout, ShFormat
from .kernel_bundle import (
    BundleKernel,
    KernelBundle,
    KernelBundleBuilder,
    ResourceGroupLayout,
    bundle_source,
)
from .transforms import model_to_world, unpack_color, unpack_cov3d, unpack_sh

# Output widths, in order: world position, rgba, sh, sigma6.
OUTPUT_WIDTHS = (4, 4, 45, 6)

UNPACK_SOURCE = r"""
__device__ void unpack_gaussian(const float* pos, const uint8_t* color,
#if !SH_NONE
                                const gs::sh_t* sh,
#endif
                                const gs::cov3d_t* cov3d, float* world,
                                float* rgba, float* sh_out, float* sigma6) {
  const float mt_pos[3] = {mt_px, mt_py, mt_pz};
  const float mt_rot[4] = {mt_qx, mt_qy, mt_qz, mt_qw};
  const float mt_scale[3] = {mt_sx, mt_sy, mt_sz};
  gs::model_to_world(mt_pos, mt_rot, mt_scale, pos, world);
  gs::unpack_color(color, rgba);
#if SH_NONE
  gs::unpack_sh(nullptr, sh_out);
#else
  gs::unpack_sh(sh, sh_out);
#endif
  gs::unpack_cov3d(cov3d, sigma6);
}
"""

_MT_NAMES = ("mt_px", "mt_py", "mt_pz", "mt_qx", "mt_qy", "mt_qz", "mt_qw",
             "mt_sx", "mt_sy", "mt_sz")


def model_constants(mt: ModelTransform) -> dict[str, float]:
    """The model transform as the bundle's constants, rounded to f32."""
    values = (*mt.pos, *mt.rot, *mt.scale)
    return {k: float(np.float32(v)) for k, v in zip(_MT_NAMES, values)}


def unpack_plain(pos, color, sh, cov3d, layout: GaussianLayout,
                 mt: ModelTransform = ModelTransform()):
    """Plain version of the kernel on whole tensors: (world [N, 4], rgba
    [N, 4], sh [N, 45], sigma6 [N, 6]) f32, on pos's device."""
    dev = pos.device
    n = pos.shape[0]
    return (
        model_to_world(*mt.as_tensors(dev), pos),
        unpack_color(color),
        unpack_sh(sh, n, dev).reshape(n, 45),
        unpack_cov3d(cov3d, rot_scale=layout.cov3d == Cov3dFormat.ROT_SCALE),
    )


def _unpack_tiles(*tiles, config: GaussianLayout, mt_px=0.0, mt_py=0.0,
                  mt_pz=0.0, mt_qx=0.0, mt_qy=0.0, mt_qz=0.0, mt_qw=1.0,
                  mt_sx=1.0, mt_sy=1.0, mt_sz=1.0):
    """The bundle's plain kernel: tiles of (pos, color, [sh,] cov3d), then
    the four output tiles."""
    n_in = 3 if config.sh == ShFormat.NONE else 4
    ins, outs = tiles[:n_in], tiles[n_in:]
    sh = None if n_in == 3 else ins[2]
    mt = ModelTransform(pos=(mt_px, mt_py, mt_pz),
                        rot=(mt_qx, mt_qy, mt_qz, mt_qw),
                        scale=(mt_sx, mt_sy, mt_sz))
    for out, val in zip(outs, unpack_plain(ins[0], ins[1], sh, ins[-1],
                                           config, mt)):
        out[...] = val


UNPACK_GAUSSIANS = BundleKernel(cuda=UNPACK_SOURCE, entry="unpack_gaussian",
                                plain=_unpack_tiles)


def unpack_source(layout: GaussianLayout,
                  mt: ModelTransform = ModelTransform()) -> str:
    """The CUDA source :func:`unpack_bundle` generates for a buffer of
    ``layout``, from the layout alone (to build ahead of the buffers)."""
    packed = [np.float32, np.uint8, layout.sh_dtype, layout.cov3d_dtype]
    in_dtypes = [torch.from_numpy(np.zeros(0, dt)).dtype
                 for dt in packed if dt is not None]
    return bundle_source(UNPACK_GAUSSIANS, in_dtypes,
                         [torch.float32] * len(OUTPUT_WIDTHS),
                         model_constants(mt), layout)


def resources(buffer: GaussiansBuffer) -> list[torch.Tensor]:
    """The buffer's tensors in the kernel's resource order."""
    d = buffer.data
    return [d.pos, d.color, *([] if d.sh is None else [d.sh]), d.cov3d]


# Threads a block: a block runs a tile of up to 112 items of up to 460
# bytes (kernel_bundle.tile_plan), four blocks an SM.
BLOCK_SIZE = 128


def unpack_bundle(buffer: GaussiansBuffer,
                  mt: ModelTransform = ModelTransform()) -> KernelBundle:
    """A bundle owning the buffer's tensors (which ``update_range`` keeps
    in place) and specialised by its layout: ``dispatch(len(buffer))``
    returns (world, rgba, sh, sigma6)."""
    res = resources(buffer)
    builder = (
        KernelBundleBuilder()
        .label(f"unpack gaussians {buffer.layout.sh.name.lower()}-"
               f"{buffer.layout.cov3d.name.lower()}")
        .resource_layout(ResourceGroupLayout("gaussians", len(res)))
        .kernel(UNPACK_GAUSSIANS)
        .layout_config(buffer.layout)
        .constants(**model_constants(mt))
    )
    for width in OUTPUT_WIDTHS:
        builder.output(width)
    return builder.block_size(BLOCK_SIZE).build([res])
