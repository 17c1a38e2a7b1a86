"""The rasterizer kernels' pixel-box cull on the card (marker ``cuda``).

K3 (``rasterize_tiles_fwd``) and K4 (``rasterize_tiles_bwd``) skip, a warp
at a time, the fragments whose conservative pixel box misses the warp's
pixels. On the scene of tests/test_torch_cuda.py and on the tiles the
cull finds hard (``tools/bench_kernel_variants.py::hard_tiles``), in SPLAT
and ELLIPSE mode: K3 equals its first design (``ops/variants.py::
rasterize_fwd_first``, no cull) and K9's ``v6_full`` (K3 compiled again
from its source) bit for bit; K4 is within 1e-4 (of each gradient row's
largest value) of its plain version and of its first design; two K4
launches are bit-identical.

These need a CUDA card and nvcc, and skip without one. On a machine with
a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_raster.py``.
"""

import pytest
import torch

from wgpu_3dgs_core_tpu_torch.ops import rasterize as TR
from wgpu_3dgs_core_tpu_torch.ops import variants as KV
from wgpu_3dgs_core_tpu_torch.ops.binning import bin_splats_attrs, pad_schedule
from wgpu_3dgs_core_tpu_torch.render.renderer import tile_local_stream
from wgpu_3dgs_core_tpu_torch.tools.bench_kernel_variants import hard_tiles

from .test_torch_cuda import _binned, cuda  # noqa: F401  (the fixture)

pytestmark = pytest.mark.cuda

BG = (0.1, 0.2, 0.3)
K4_TOL = 1e-4
MODES = [0, 1]


def _scene_stream(device, mode):
    """tests/test_torch_cuda.py's scene binned as the renderer bins it in
    ``mode``: K3's (frags, tile_start, draw_len)."""
    spl, attr, tx, ty = _binned(device)
    stream, attrs_sorted, _ = bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr, tx, ty, 8192,
        opacity_cull=mode != 1)
    sched = pad_schedule(stream, 8192 + tx * ty * 128)
    frags = tile_local_stream(attrs_sorted, stream.tile_id, tx)
    return frags, stream.tile_start, sched.draw_len


def _streams(device, mode):
    """K3's arguments on the scene and on every hard tile set."""
    out = [("scene", _scene_stream(device, mode))]
    out += list(hard_tiles(device).items())
    return [(name, (*st, BG, 9.0, mode)) for name, st in out]


def _k4_args(k3, seed=0):
    frags, start, draw_len, bg, cutoff_sq, mode = k3
    out = TR.rasterize_tiles_fwd(*k3)
    g = torch.randn(out.shape, device=out.device,
                    generator=torch.Generator(out.device).manual_seed(seed))
    return (frags, start, draw_len, draw_len, out, g, bg, cutoff_sq, mode)


def _normalized(got, want):
    scale = want.abs().amax(dim=1)
    err = (got - want).abs().amax(dim=1)
    return float(torch.where(scale > 0, err / scale, err).max())


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("mode", MODES)
def test_k3_equals_its_first_design(cuda, mode):
    """K3 with the cull equals its first design (K3 without it) and K9's
    v6_full bit for bit, and its plain version within 3e-5."""
    for name, k3 in _streams(cuda, mode):
        got = TR.rasterize_tiles_fwd(*k3)
        assert torch.equal(_bits(KV.rasterize_fwd_first(*k3)),
                           _bits(got)), name
        assert torch.equal(_bits(KV.rasterize_level("v6_full", *k3)),
                           _bits(got)), name
        err = float((got - TR.rasterize_tiles_fwd_plain(*k3)).abs().max())
        assert err <= 3e-5, (name, err)


@pytest.mark.parametrize("mode", MODES)
def test_k4_matches_plain_and_first_design(cuda, mode):
    """K4 within 1e-4 of its plain version and of its first design, which
    is itself within 1e-4 of the plain version."""
    for name, k3 in _streams(cuda, mode):
        k4 = _k4_args(k3)
        got = TR.rasterize_tiles_bwd(*k4)
        plain = TR.rasterize_tiles_bwd_plain(*k4)
        first = KV.rasterize_bwd_first(*k4)
        assert bool(torch.isfinite(got).all()), name
        assert _normalized(got, plain) <= K4_TOL, name
        assert _normalized(got, first) <= K4_TOL, name
        assert _normalized(first, plain) <= K4_TOL, name


@pytest.mark.parametrize("mode", MODES)
def test_k4_is_deterministic(cuda, mode):
    """Two K4 launches on the same inputs give the same bits."""
    for name, k3 in _streams(cuda, mode):
        k4 = _k4_args(k3, seed=2)
        first = TR.rasterize_tiles_bwd(*k4)
        assert torch.equal(_bits(first),
                           _bits(TR.rasterize_tiles_bwd(*k4))), name
