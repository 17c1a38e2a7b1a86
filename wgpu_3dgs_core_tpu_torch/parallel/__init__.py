"""The sharded renderer on ``torch.distributed``: the counterpart of
``wgpu_3dgs_core_tpu.parallel`` (mesh helpers, ``render_sharded``), and
:mod:`.launch`, which starts D ranks of one machine."""

from .mesh import (
    DATA_AXIS,
    gaussian_sharding,
    initialize_multihost,
    make_mesh,
    pad_to_multiple,
    replicated,
)
from .sharded import render_sharded

__all__ = [
    "DATA_AXIS",
    "gaussian_sharding",
    "initialize_multihost",
    "make_mesh",
    "pad_to_multiple",
    "replicated",
    "render_sharded",
]
