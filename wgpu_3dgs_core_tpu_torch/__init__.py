"""wgpu_3dgs_core_tpu_torch: the differentiable renderer and training loop
of wgpu_3dgs_core_tpu in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (sm_90a).

The JAX package ``wgpu_3dgs_core_tpu`` is the reference this port is held
against; this package imports ``torch`` and never ``jax``. Module names
mirror the JAX package's. The hot path runs six kernels built from
``csrc/`` on first use (ops/cuda.py): K1 and K2, the two levels of
fragment expansion (ops/expand.py); K3 and K4, the forward tile rasterizer
and its backward (ops/rasterize.py); K5 and K6, the backward's segment
sums per gaussian and their scatter back to gaussian order
(ops/segreduce.py). On CPU tensors each runs its plain torch version.
Entry points run on the card unless they are given CPU tensors or
``device="cpu"``.
"""

from .buffer import (  # noqa: F401
    GaussianDisplayMode,
    GaussiansBuffer,
    GaussianTransform,
    ModelTransform,
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
from .ops import launch_counts, reset_launch_counts  # noqa: F401
from .render import (  # noqa: F401
    Camera,
    RenderResult,
    TrainableGaussians,
    fit,
    l2_image_loss,
    make_train_step,
    measure_max_fragments,
    measure_max_rows,
    render,
    render_gaussians,
    render_reference,
)

__version__ = "0.1.0"
