"""Process-group and device-mesh helpers for the sharded renderer.

The counterpart of ``wgpu_3dgs_core_tpu.parallel.mesh`` on
``torch.distributed``: one process per rank (one card each under NCCL,
or several ranks on the CPU or on one card under gloo), gaussians sharded
over a 1-D ``data`` mesh axis, tiles strip-partitioned over the same axis.
``initialize_multihost`` brings the process group up before
:func:`make_mesh`; ``distribute_tensor(x, mesh, gaussian_sharding(mesh))``
is the counterpart of ``jax.device_put(x, gaussian_sharding(mesh))``.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
# A collective that waits longer than this raises instead of hanging.
COLLECTIVE_TIMEOUT = timedelta(seconds=300)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> int:
    """Bring up the default process group and return this process's rank.

    ``coordinator_address`` is ``host:port`` of rank 0's TCP store, the
    same string on every process; without it the group is read from the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``: ``env://``). ``local_device_ids`` names the card this
    process drives (one id); it is made current before the group starts.
    ``backend`` defaults to NCCL where CUDA is available and gloo
    elsewhere. Safe to call twice: a second call is a no-op and returns
    the rank::

        # on each of two hosts, process_id 0 and 1:
        initialize_multihost("10.0.0.1:8476", num_processes=2,
                             process_id=i, local_device_ids=[0])
        mesh = make_mesh()
    """
    if dist.is_initialized():
        return dist.get_rank()
    if local_device_ids is not None:
        if len(local_device_ids) != 1:
            raise ValueError("one card per process: local_device_ids takes "
                             f"one id, got {list(local_device_ids)}")
        torch.cuda.set_device(int(local_device_ids[0]))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    else:
        kw = dict(init_method="env://")
    dist.init_process_group(backend, timeout=COLLECTIVE_TIMEOUT, **kw)
    return dist.get_rank()


def make_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """1-D mesh named ``("data",)`` over the first ``n_devices`` ranks of
    the default group (default: all of them). Every rank of the group
    calls it. Its device type follows the group's backend: ``cuda`` under
    NCCL, ``cpu`` under gloo (which also carries CUDA tensors, staged
    through the host)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_multihost first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(n)),
                      mesh_dim_names=(DATA_AXIS,))


def gaussian_sharding(mesh: DeviceMesh) -> tuple:
    """Placements that shard the leading (gaussian) axis over ``data``."""
    return (Shard(0),)


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(),)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` (a tensor, or an array, returned as a tensor) with zeros
    along ``axis`` so that shards divide evenly. Returns (padded, the
    original length)."""
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n
