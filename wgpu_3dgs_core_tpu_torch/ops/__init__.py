from . import probe, variants  # noqa: F401  (the K9-K11 launch counts)
from .cuda import launch_counts, reset_launch_counts
from .kernel_bundle import (
    DEFAULT_BLOCK_SIZE,
    MAX_BLOCK_SIZE,
    BundleKernel,
    KernelBundle,
    KernelBundleBuilder,
    OutputSpec,
    ResourceGroupLayout,
)
from .transforms import (
    cov3d_from_rot_scale,
    model_scale_rot_mat,
    model_to_world,
    model_transform_inv_sr_mat,
    model_transform_mat,
    quat_to_mat3,
    sigma6_to_mat3,
    unpack_color,
    unpack_cov3d,
    unpack_sh,
)

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "DEFAULT_BLOCK_SIZE",
    "MAX_BLOCK_SIZE",
    "BundleKernel",
    "KernelBundle",
    "KernelBundleBuilder",
    "OutputSpec",
    "ResourceGroupLayout",
    "cov3d_from_rot_scale",
    "model_scale_rot_mat",
    "model_to_world",
    "model_transform_inv_sr_mat",
    "model_transform_mat",
    "quat_to_mat3",
    "sigma6_to_mat3",
    "unpack_color",
    "unpack_cov3d",
    "unpack_sh",
]
