"""Device operations by kind, from their names in the profiler's trace.

A copy of the port's table of kinds (``utils/profiling.py``,
``KERNEL_KINDS``), frozen here so that a change to the program cannot
change how the benchmark reads a trace: (kind, substring of the
operation's name), the first match wins. The kinds whose name starts
with "K" are the port's hand-written kernels; every other device
operation is PyTorch's.
"""

from __future__ import annotations

KERNEL_KINDS = (
    ("K3 rasterize_fwd", "rasterize_fwd_kernel"),
    ("K4 rasterize_bwd", "rasterize_bwd_kernel"),
    ("K5 prep", "segment_sums_prep_kernel"),
    ("K5 segment_sums", "segment_sums_kernel"),
    ("K6 uncompact", "uncompact_kernel"),
    ("K2 expand_fragments", "expand_fragments_kernel"),
    ("K1 expand_rows", "expand_rows_kernel"),
    ("radix sort", "RadixSort"),
    ("cat/stack", "CatArray"),
    ("index/gather", "index"),
    ("reduce/scan", "reduce"),
    ("reduce/scan", "Scan"),
    ("copy/fill", "Memcpy"),
    ("copy/fill", "Memset"),
    ("NCCL collectives", "nccl"),
    ("elementwise", "elementwise"),
)


def kernel_kind(name: str) -> str:
    """The kind of a device operation's name, else "other"."""
    for kind, key in KERNEL_KINDS:
        if key in name:
            return kind
    return "other"


def is_hand_kernel(name: str) -> bool:
    """Whether a device operation is one of the port's hand kernels."""
    return kernel_kind(name).startswith("K")
