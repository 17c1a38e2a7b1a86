"""Start D ranks of one process group and run a function on each.

:func:`spawn_ranks` is how the tests, ``entry.dryrun_multichip`` and
``chip_smoke.py`` run the sharded renderer on D ranks of one machine:

- ranks are processes of the ``spawn`` start method, each running
  :func:`_worker` of this module, which imports torch and this package and
  nothing else of the caller's (no test module, no jax);
- the group meets at a free ``localhost`` port through
  ``initialize_multihost``, with the backend the caller names: NCCL where
  each rank has its own card, gloo where ranks share one card or run on
  the CPU; nothing falls back from one to the other;
- each rank's result comes back as CPU tensors (``torch.save`` bytes over
  a queue); each rank's output goes to a log, returned in the error when
  a rank fails;
- the ranks are joined within one time limit, and killed past it, or
  shortly after another rank failed (its peers would wait on it in a
  collective).

:func:`render_step` is the rank function the tests and ``chip_smoke.py``
run: the sharded render of a scene, its gradients, and what its strip
holds.
"""

from __future__ import annotations

import io
import os
import queue as queue_mod
import socket
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.cuda import launch_counts, reset_launch_counts
from .mesh import initialize_multihost, make_mesh
from .sharded import render_sharded, strip_stats

# How long the other ranks may run on after one has failed, in seconds.
FAILURE_GRACE = 10.0
# The tail of a failed rank's log kept in the error, in characters.
LOG_TAIL = 6000


def free_port() -> int:
    """A TCP port of localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _worker(rank: int, world: int, port: int, backend: str, device: str,
            fn: Callable, args: tuple, log_path: str, results) -> None:
    """One rank: its output to ``log_path``, the group up, ``fn`` run, and
    (rank, error text or None, result bytes) put on ``results``."""
    log = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(log, 1)
    os.dup2(log, 2)
    try:
        if device == "cpu":
            torch.set_num_threads(1)  # D ranks share the host's cores
            dev = torch.device("cpu")
            ids = None
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            ids = [dev.index]
        initialize_multihost(f"localhost:{port}", world, rank,
                             local_device_ids=ids, backend=backend)
        out = fn(rank, world, dev, *args)
        buf = io.BytesIO()
        torch.save(_to_cpu(out), buf)
        results.put((rank, None, buf.getvalue()))
        dist.destroy_process_group()
    except BaseException:
        err = traceback.format_exc()
        print(err, file=sys.stderr, flush=True)
        sys.stdout.flush()
        results.put((rank, err, None))
        results.close()
        results.join_thread()  # the message is in the pipe before exit
        os._exit(1)  # skip teardown: a peer may hold the group open


def _tail(path: Path) -> str:
    try:
        return path.read_text(errors="replace")[-LOG_TAIL:]
    except OSError:
        return ""


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (), *,
                backend: str, device: str = "cuda",
                timeout: float = 300.0) -> list:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` new
    processes that form one process group, and return each rank's result
    (tensors moved to the CPU) in rank order.

    ``fn`` must be importable by name (a module-level function), and
    ``args`` picklable. ``device`` is ``"cuda"`` (the default) or
    ``"cpu"``: on CUDA rank r drives card r modulo the cards it sees, so
    under gloo several ranks may share one card, and under NCCL each needs
    its own. Raises
    RuntimeError, with every failed rank's traceback and log, if a rank
    fails or the ranks do not all finish within ``timeout`` seconds; the
    ranks are killed then.
    """
    import multiprocessing as mp

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if backend == "nccl" and (
            device != "cuda" or world_size > torch.cuda.device_count()):
        raise ValueError(
            f"NCCL takes one card a rank: {world_size} ranks on "
            f"{torch.cuda.device_count() if device == 'cuda' else 0} cards "
            f"({device}); use gloo to share a card or run on the CPU")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="gs_ranks_") as tmp:
        logs = [Path(tmp) / f"rank{r}.log" for r in range(world_size)]
        procs = [
            ctx.Process(target=_worker, daemon=True, args=(
                r, world_size, port, backend, device, fn, tuple(args),
                str(logs[r]), results))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        done: dict[int, bytes] = {}
        errors: dict[int, str] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(done) + len(errors) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, err, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):
                        if (p.exitcode not in (None, 0) and r not in done
                                and r not in errors):
                            errors[r] = f"exited with code {p.exitcode}"
                            deadline = min(deadline, time.monotonic()
                                           + FAILURE_GRACE)
                    continue
                if err is None:
                    done[rank] = payload
                else:
                    errors[rank] = err
                    deadline = min(deadline, time.monotonic() + FAILURE_GRACE)
        finally:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 0.0) + 5.0)
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
        missing = [r for r in range(world_size)
                   if r not in done and r not in errors]
        if errors or missing:
            parts = [f"rank {r} did not finish within {timeout:.0f} s"
                     for r in missing]
            parts += [f"rank {r} failed:\n{e}"
                      for r, e in sorted(errors.items())]
            for r in sorted(set(errors) | set(missing)):
                parts.append(f"--- rank {r} log ---\n{_tail(logs[r])}")
            raise RuntimeError(
                f"{world_size} ranks ({backend}, {device}): "
                + "\n".join(parts))
    return [torch.load(io.BytesIO(done[r]), weights_only=True)
            for r in range(world_size)]


def _shard(a: Optional[np.ndarray], rank: int, world: int, device):
    if a is None:
        return None
    n = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(
        a[rank * n:(rank + 1) * n])).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_step(rank: int, world: int, device: torch.device, scene: tuple,
                camera, cases: Sequence[dict], target=None,
                twice: bool = False, time_steps: int = 0) -> list:
    """This rank's part of the sharded render of ``scene`` for each case.

    ``scene``: (means, cov3d_sigma6, colour, opacity, sh or None) of the
    whole scene as numpy arrays; this rank takes its shard. ``cases``: the
    keyword arguments of :func:`render_sharded` of each render. With a
    ``target`` (numpy [H, W, 3]) the loss is sum((image - target)^2), else
    mean(image^2). Returns one dict a case: the image, transmittance and
    overflow; the gradients of the loss w.r.t. the shard's (means, cov3d,
    colour, opacity, sh); the kernels' launches over that render and its
    backward; what the strip holds (:func:`strip_stats`); with ``twice``
    whether a second render and backward gave bit-identical gradients;
    with ``time_steps`` the wall time of each of that many more steps
    (synchronised), in ms; and the seconds since this function began
    (``seconds``: what the rank spent beyond its start-up).
    """
    t_start = time.perf_counter()
    mesh = make_mesh(world)
    shard = [_shard(a, rank, world, device) for a in scene]
    tgt = None if target is None else torch.from_numpy(target).to(device)
    out = []
    for kw in cases:
        leaves = [None if t is None else t.clone().requires_grad_(True)
                  for t in shard]
        live = [t for t in leaves if t is not None]

        def step():
            res = render_sharded(*leaves[:4], camera, mesh, sh=leaves[4],
                                 **kw)
            loss = (torch.mean(res.image ** 2) if tgt is None
                    else torch.sum((res.image - tgt) ** 2))
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            return res, loss, [torch.zeros_like(t) if g is None else g
                               for t, g in zip(live, grads)]

        _sync(device)
        reset_launch_counts()
        res, loss, grads = step()
        _sync(device)
        launches = launch_counts()
        item = dict(image=res.image.detach(),
                    transmittance=res.transmittance.detach(),
                    overflow=bool(res.overflow), loss=float(loss),
                    grads=grads, launches=launches,
                    stats=strip_stats(*shard[:4], camera, mesh, sh=shard[4],
                                      **kw))
        if twice:
            again = step()[2]
            item["identical"] = all(torch.equal(a, b)
                                    for a, b in zip(grads, again))
        times = []
        for _ in range(time_steps):
            _sync(device)
            t0 = time.perf_counter()
            step()
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        item["step_ms"] = times
        item["seconds"] = time.perf_counter() - t_start
        out.append(item)
    return out
