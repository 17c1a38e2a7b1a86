"""Segment reduction of the backward's per-fragment gradients: kernels K5
and K6, with their plain versions.

The counterpart of ``wgpu_3dgs_core_tpu.ops.segreduce``. After K4 writes a
[9, F] gradient per stream slot, one sort of the slots by key
(:func:`sort_keys`: the gaussian id of each drawn slot, ``n + slot`` for
the rest) groups them gaussian-major. Then:

- K5, :func:`segment_sums_sorted` (replaces ``_segsum_kernel``): for each
  row of the ascending compacted gid column (:func:`gid_column_sorted`),
  the sum of the gradient rows of the sorted slots whose key equals that
  gid, read through the sort's permutation. Ownership is by key equality,
  so fragments missing from the stream contribute nothing.
- K6, :func:`uncompact_columns` (replaces ``_uncompact_kernel``): the
  compacted sums back in original gaussian order, exact zeros for
  gaussians with no fragments.

K5's kernel puts its lanes over the sorted slots, not over rows: each
block sums the runs of equal keys whose first slot lies in its chunk of
:data:`SEGSUM_CHUNK` slots (walking on past the chunk to finish its last
run) with a segmented scan, and writes each run's sums to the row holding
its key; rows no run reaches are zeros. A first kernel copies the
gradients slot-major into scratch, so the gather through the permutation
reads a slot's 9 values from one place. K5 and K6 are deterministic
(no atomics). On CUDA tensors the wrappers launch ``csrc/segreduce.cu``;
on CPU tensors they run the plain versions. The TPU's one-hot MXU windows
and bf16 splits are not carried over.
"""

from __future__ import annotations

import torch

from .cuda import CudaKernel, I, P, check, on_cpu
from .expand import TAB_CNT, TAB_GID

GRAD_ROWS = 9
# The slots whose runs one block of K5 owns, walked in two tiles
# (csrc/segreduce.cu's kChunk and kTile): streams built to test K5 place
# their runs against them.
SEGSUM_CHUNK = 2048


def gid_column_sorted(table_ints: torch.Tensor, n: int) -> torch.Tensor:
    """The ascending gid column of a (depth-ordered) per-gaussian table's
    int rows (``SegmentTable.ints``): the gids of the rows that own
    fragments, sorted, then the sentinel ``n`` for every other row. Int32
    [rows]."""
    col = torch.where(table_ints[TAB_CNT] > 0, table_ints[TAB_GID], n)
    return torch.sort(col).values


def sort_keys(gauss_id, tile_id, tile_start, draw_len, n: int):
    """Sort the stream's slots by gaussian: the key of a slot the
    rasterizer drew is its gaussian id, every other slot's is ``n + slot``
    (past every gaussian). The sort is stable, so a gaussian's slots keep
    their stream order and K5 sums them in the same order on every run.
    Returns (sorted int32 keys, int64 permutation: the slot of each sorted
    key)."""
    f = gauss_id.shape[0]
    t_total = tile_start.shape[0]
    if n + f >= 2**31:
        raise ValueError("segment reduce requires n + F < 2^31 (int32 keys)")
    slot = torch.arange(f, dtype=torch.int32, device=gauss_id.device)
    tile = torch.clamp_max(tile_id, t_total - 1).long()
    drawn = (tile_id < t_total) & (slot - tile_start[tile] < draw_len[tile])
    key = torch.where(drawn, gauss_id, slot + n)
    return torch.sort(key, stable=True)


# -------------------------------------------------------------------- K5


def segment_sums_sorted_plain(keys, perm, grad, gid_col,
                              n: int) -> torch.Tensor:
    """Plain version of K5: run bounds by ``searchsorted``, sums as
    differences of an f64 cumsum of the sorted gradient rows."""
    f = keys.shape[0]
    lo = torch.searchsorted(keys, gid_col)
    hi = torch.searchsorted(keys, gid_col, right=True)
    csum = torch.zeros((GRAD_ROWS, f + 1), dtype=torch.float64,
                       device=grad.device)
    csum[:, 1:] = torch.cumsum(grad[:, perm].double(), dim=1)
    sums = (csum[:, hi] - csum[:, lo]).float()
    return torch.where(gid_col < n, sums, 0.0)


def check_segsum_args(keys, perm, grad, gid_col):
    """Validate K5's tensor arguments (dtypes, shapes, layout)."""
    f, rows = keys.shape[0], gid_col.shape[0]
    check(keys, "keys", torch.int32, (f,))
    check(perm, "perm", torch.int64, (f,))
    check(grad, "grad", torch.float32, (GRAD_ROWS, f))
    check(gid_col, "gid_col", torch.int32, (rows,))


SEGMENT_SUMS = CudaKernel(
    "segment_sums", "gs_segment_sums", [P, P, P, I, P, I, I, P, P, P],
)


def segment_sums_sorted(keys, perm, grad, gid_col, n: int) -> torch.Tensor:
    """K5: per-row sums [9, rows] of the gradient ``grad`` [9, F] (slot
    order) over the slots whose sorted ``keys`` [F] (int32, with ``perm``
    [F] int64 the slot of each) equal the row's ``gid_col`` entry; rows
    holding the sentinel ``n`` get zeros."""
    check_segsum_args(keys, perm, grad, gid_col)
    if on_cpu(keys, perm, grad, gid_col):
        return segment_sums_sorted_plain(keys, perm, grad, gid_col, n)
    f, rows = keys.shape[0], gid_col.shape[0]
    dev = grad.device
    out = torch.empty((GRAD_ROWS, rows), dtype=torch.float32, device=dev)
    # Scratch: the gradients slot-major, and each gaussian's row.
    grad_t = torch.empty((f, GRAD_ROWS), dtype=torch.float32, device=dev)
    row_of = torch.empty(n, dtype=torch.int32, device=dev)
    SEGMENT_SUMS.launch(
        keys.data_ptr(), perm.data_ptr(), grad.data_ptr(), f,
        gid_col.data_ptr(), rows, n, out.data_ptr(), grad_t.data_ptr(),
        row_of.data_ptr(), work=rows, device=dev,
    )
    return out


# -------------------------------------------------------------------- K6


def uncompact_columns_plain(comp, gid_col, n: int) -> torch.Tensor:
    """Plain version of K6 (``searchsorted`` + gather + ``where``), equal
    to the kernel bit for bit."""
    rows = gid_col.shape[0]
    if rows == 0:
        return torch.zeros((GRAD_ROWS, n), dtype=torch.float32,
                           device=comp.device)
    g = torch.arange(n, dtype=torch.int32, device=comp.device)
    r = torch.clamp_max(torch.searchsorted(gid_col, g), rows - 1)
    found = gid_col[r] == g
    return torch.where(found[None, :], comp[:, r], 0.0)


UNCOMPACT = CudaKernel("uncompact", "gs_uncompact", [P, P, I, I, P])


def uncompact_columns(comp, gid_col, n: int) -> torch.Tensor:
    """K6: the compacted sums ``comp`` [9, rows] (column r belongs to
    gaussian ``gid_col[r]``) in original gaussian order, [9, n]; exact
    zeros for gaussians the column does not hold."""
    rows = gid_col.shape[0]
    check(comp, "comp", torch.float32, (GRAD_ROWS, rows))
    check(gid_col, "gid_col", torch.int32, (rows,))
    if on_cpu(comp, gid_col):
        return uncompact_columns_plain(comp, gid_col, n)
    dev = comp.device
    out = torch.empty((GRAD_ROWS, n), dtype=torch.float32, device=dev)
    UNCOMPACT.launch(comp.data_ptr(), gid_col.data_ptr(), rows, n,
                     out.data_ptr(), work=n, device=dev)
    return out
