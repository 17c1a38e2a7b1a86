"""wgpu_3dgs_core_tpu_torch: the differentiable renderer and training loop
of wgpu_3dgs_core_tpu in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (sm_90a).

The JAX package ``wgpu_3dgs_core_tpu`` is the reference this port is held
against; this package imports ``torch`` and never ``jax``. Module names
mirror the JAX package's. Scenes are read and written on the host in both
of the reference's formats (models/): PLY, and SPZ, whose quantization
codecs run in numpy or, for large arrays, in the port's own build of
``csrc/spz_codec.cpp`` (utils/native.py, ``g++`` into ``_build/spz/``);
``Gaussians`` dispatches by source and ``GaussianSoA`` is the canonical
form that ``GaussiansBuffer`` uploads. The render path runs six kernels built from
``csrc/`` on first use (ops/cuda.py): K1 and K2, the two levels of
fragment expansion (ops/expand.py); K3 and K4, the forward tile rasterizer
and its backward (ops/rasterize.py); K5 and K6, the backward's segment
sums per gaussian and their scatter back to gaussian order
(ops/segreduce.py). The core layer's compute path runs K8, the kernel
bundle launcher (ops/kernel_bundle.py, with the device library
csrc/gaussian.cuh; ops/unpack_bundle.py unpacks a GaussiansBuffer through
it), and the one-level binning K7 (ops/expand.py, ops/binning.py
bin_splats). The measurement path adds K9 and K10, the rasterizer and
the segment sums stripped level by level (ops/variants.py), and K11, a
probe of launches bounded by a count on the device (ops/probe.py), which
the tools (tools/) check and time. On CPU tensors each runs its plain
torch version. The sharded renderer (parallel/) runs the render path's
kernels on every rank of a torch.distributed group; entry.py holds the
entry points: a forward render and one sharded training step.
Entry points run on the card unless they are given CPU tensors or
``device="cpu"``.
"""

from .buffer import (  # noqa: F401
    FixedSizeBufferWrapper,
    GaussianDisplayMode,
    GaussiansBuffer,
    GaussianTransform,
    ModelTransform,
    download,
)
from .errors import *  # noqa: F401,F403
from .layouts import (  # noqa: F401
    ALL_LAYOUTS,
    Cov3dFormat,
    GaussianLayout,
    PackedGaussians,
    ShFormat,
    pack,
    unpack,
)
from .models import *  # noqa: F401,F403
from .ops import (  # noqa: F401
    BundleKernel,
    KernelBundle,
    KernelBundleBuilder,
    OutputSpec,
    ResourceGroupLayout,
    launch_counts,
    reset_launch_counts,
)
from .render import (  # noqa: F401
    Camera,
    RenderResult,
    TrainableGaussians,
    fit,
    l2_image_loss,
    make_train_step,
    measure_capacities,
    measure_max_fragments,
    measure_max_rows,
    render,
    render_gaussians,
    render_reference,
)

__version__ = "0.1.0"
