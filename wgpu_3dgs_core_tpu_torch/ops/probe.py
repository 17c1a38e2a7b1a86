"""K11, the live-bound launch probe, with its plain version.

The counterpart of ``tools/probe_dyngrid.py::run``, which asks whether a
Pallas TPU grid may be sized by a traced count. A kernel cannot size its
own grid, so :func:`probe` runs the probe's body, ``out = x + 1`` over
blocks of ``block_elems`` f32, with the live block count in a device
int32, in three launch forms (``csrc/probe_dyngrid.cu``):

- ``capacity``: a grid over every capacity block; blocks past the count
  return at once (the form K1, K2 and K7 use);
- ``readback``: the host reads the count (one sync), then launches a grid
  of the live blocks;
- ``device_launch``: a one-thread parent kernel reads the count and
  launches the child grid from the device (dynamic parallelism; the
  source is built relocatable into a library of its own, see
  ``ops/cuda.py``).

Every form writes the live prefix and leaves the rest of ``out`` as it
was. ``tools/probe_dyngrid.py`` checks and times the forms.
"""

from __future__ import annotations

import torch

from .cuda import (
    CSRC_DIR,
    I,
    Launcher,
    P,
    bind,
    build_sources,
    bundle_library,
    check,
    on_cpu,
)

FORMS = ("capacity", "readback", "device_launch")
SOURCE = "probe_dyngrid.cu"

PROBE = Launcher("probe_dyngrid")
# The loaded library ("lib") and each form's bound C entry, all taking
# (x, out, live_blocks, blocks, block_elems, stream): blocks is the
# capacity, or the live count for readback.
_loaded: dict = {}


def build():
    """The probe's library (built relocatable on first use)."""
    src = (CSRC_DIR / SOURCE).read_text()
    return build_sources([src], relocatable=True)[0]


def _library() -> dict:
    if not _loaded:
        lib = bundle_library(build().path)
        _loaded["lib"] = lib
        for form in FORMS:
            _loaded[form] = bind(lib, f"gs_probe_{form}", [P, P, P, I, I])
    return _loaded


def probe_plain(x, out, live_blocks, block_elems: int) -> torch.Tensor:
    """Plain version of every form: ``out[:live] = x[:live] + 1``, live
    the count (clamped to [0, capacity]) times ``block_elems``."""
    cap = x.shape[0] // block_elems
    live = min(max(int(live_blocks), 0), cap) * block_elems
    out[:live] = x[:live] + 1.0
    return out


def probe(form: str, x, out, live_blocks, block_elems: int) -> torch.Tensor:
    """K11 in launch form ``form``: ``out[:live] = x[:live] + 1`` in place,
    with ``live_blocks`` (int32 [1], on the device) blocks of
    ``block_elems`` live, at most ``x.shape[0] // block_elems``; the rest of
    ``out`` is untouched. Returns ``out``."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; expected one of {FORMS}")
    f = x.shape[0]
    check(x, "x", torch.float32, (f,))
    check(out, "out", torch.float32, (f,))
    check(live_blocks, "live_blocks", torch.int32, (1,))
    if block_elems <= 0 or f % block_elems:
        raise ValueError(f"{f} elements are not whole blocks of "
                         f"{block_elems}")
    if on_cpu(x, out, live_blocks):
        return probe_plain(x, out, live_blocks, block_elems)
    cap = f // block_elems
    dev = x.device
    loaded = _library()
    ptrs = (x.data_ptr(), out.data_ptr(), live_blocks.data_ptr())
    if form == "readback":
        blocks = min(int(live_blocks), cap)  # the sync this form pays
        PROBE.call(loaded[form], loaded["lib"], *ptrs, blocks, block_elems,
                   work=blocks, device=dev)
    else:
        PROBE.call(loaded[form], loaded["lib"], *ptrs, cap, block_elems,
                   work=cap, device=dev)
    return out
