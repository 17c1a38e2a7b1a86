"""Smoke run of the PyTorch + CUDA port (wgpu_3dgs_core_tpu_torch) on a GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Phases, one line each:

1. build the port's kernels from its csrc/ sources and the kernel-bundle
   sources of phases 10-11 (one nvcc per source, all started together),
   print ptxas's registers, shared memory and stack of each rasterizer
   and segment-sum kernel, and check that K3 and K5's two kernels, built
   again from the same source as K9's v6_full and K10's s2_gather
   (csrc/variants.cu), get the same resources there;
2. hold each forward kernel against its plain torch version on the card,
   on a mid scene (65,536 gaussians, 512x512): K1 and K2 bit for bit, K1's
   row-table form (ops/binning.py::expand_row_table, the render path's
   K1) bit for bit row_table(expand_rows_plain(...)), K2's record form
   (ops/expand.py::expand_fragment_records, the render path's K2) and K14
   (ops/binning.py::sorted_fetch) bit for bit their plain versions, what
   they replace (K2's row form transposed; its [10, F] gather through the
   tile sort's permutation, tile_local_stream and the gid cast) and their
   last launch, K3 within 3e-5 (the card's exp and FMA contraction differ
   from torch's);
3. hold the forward slice (render_gaussians through the kernels) against
   the brute-force reference renderer on the card (2,500 gaussians,
   256x192) within 1e-4 max abs: the tiled and brute-force renderers sum
   in different orders;
4. render the bench scene (1,000,000 gaussians, 1920x1080, sh_deg 3,
   pad_slack 0.65) through render_gaussians, check it, show that each
   forward kernel ran on that path, and time it (median of 10 after 2
   warm-ups, CUDA events) and each kernel: its device time (device_ms: the
   median over 10 back-to-back calls of the device operations one call
   launches, by torch.profiler), one call by CUDA events (what a caller
   pays, the wrapper's host work included) and its plain version; K1's
   row-table form bit for bit its composition there too, and its device
   ms in turns with K1's row stream + row_table (median of 3 device_ms);
   K2's record form and K14 checked as in phase 2, and K14's device ms in
   turns with the gather + tile_local_stream + cast it replaces;
5. profile the bench-scene forward: host enqueue time against wall time
   of back-to-back forwards, and torch.profiler's device kernels per
   forward (count, time, time by kind);
6. hold each backward kernel against its plain version on the mid scene
   with a random cotangent: K4 within 1e-4 of the largest gradient of its
   row, K5 within 1e-5 of the largest sum of its row, K6 bit for bit; K5
   on the seven streams its design finds hard (tools/bench_segsum.py::
   hard_streams) within 1e-5, zeros in the rows no run reaches, two
   launches bit-identical; K4 in SPLAT and ELLIPSE mode on the mid stream
   and on the tiles the pixel-box cull finds hard (tools/
   bench_kernel_variants.py::hard_tiles) within 1e-4 of its plain version,
   two launches bit-identical; two backward passes of the slice give
   bit-identical gradients;
7. hold the slice's gradients (means, quats, scales, colour, opacity, sh;
   loss sum((image - target)^2)) against autograd of render_reference on
   the card, on the spec scene, within 1e-4 of each parameter's largest
   gradient;
8. the training step on the bench scene: forward + backward of mean(
   image^2) w.r.t. (means, cov3d, colour, opacity, sh), checked (no
   overflow, finite gradients, K1-K6 and K12's two kernels launched on
   that path) and timed beside the forward; three Adam steps of make_train_step on
   TrainableGaussians at the same size; each backward kernel held against
   its plain version and timed as in phase 4 and, for K5 and K6, beside
   the device time of the one PyTorch call that computes the same
   function (segment_reduce; torch.zeros + index_copy_); K4 within 1e-4 of
   its plain version on the bench stream and the hard tiles, two launches
   bit-identical; K12, the SH colour's forward and backward
   kernels (csrc/sh.cu), on the bench scene's colour, sh and means at
   sh_deg 3 with a random cotangent: the forward bit for bit its plain
   version; the backward's d_base bit for bit the closed form's
   (ops/sh.py::sh_color_bwd_plain), its d_sh within 1e-4 of each
   gaussian's largest value of the closed form in float64, and its
   d_means within the larger of 1e-4 and twice the float32 closed form's
   own worst error there (where a gaussian's gradient is nearly radial
   the tangential projection cancels, and float32 misses by up to ~2e-4
   a million gaussians), over the gaussians whose colour lies on the
   same side of the 0 clamp in both precisions (the kernel takes that
   gate from its float32 colour, the forward's bits); each timed as in
   phase 4 beside its plain version;
9. the profile of phase 5 for the training step;
10. K8, the kernel-bundle launcher, at mid size (66,773 items, a ragged
    tail): every bundle shape of tests/test_kernel_bundle.py (map_add,
    constants, both resource-ownership states, update_resources, several
    groups and outputs, [N, 8] rows, entry points, a config-specialised
    kernel), f16/i8/u8 casts, 3-byte rows at an odd address and a map_add
    of 1,000 items (below one tile), each against the plain launcher on CPU
    copies of its inputs, bit for bit, with each one's tile plan;
11. the core layer's compute path at full width: the bench scene's 1M
    gaussians packed in each of the 12 layouts, uploaded into a
    GaussiansBuffer, unpacked by a layout-specialised bundle through
    csrc/gaussian.cuh (world position under a model transform, rgba, sh,
    sigma6) and held to the port's plain unpack (casts bit for bit,
    ROT_SCALE sigma within 1e-6 of the row's largest |sigma|); a quarter
    of the buffer updated in place and unpacked again; download_packed
    equal to the host pack bit for bit; download_gaussians round-tripping
    the 3 reversible layouts and raising IrreversibleConfigError on the 9
    others. The SINGLE/ROT_SCALE unpack and a map_add bundle over 2^24 f32
    items are timed in turns with torch.add (median of 3 device_ms), and
    by one call each; the host's enqueue per dispatch
    (bundle-owned and caller-managed resources) beside torch.add's, and
    the tile plans;
12. K7: one-level bin_splats of the mid scene and of the bench scene's
    projection at 1920x1080 (capacity: count_fragments x 1.5 rounded up
    to 512), no overflow, every FragmentStream field equal to the same
    binning on the CPU, K7 bit for bit against its plain version there and
    on the hard tables of tools/expand_tables.py, and timed (median of 3
    device_ms) beside its plain version;
13. K11, the live-bound launch probe (tools/probe_dyngrid.py): its three
    launch forms (a capacity grid, a host readback, a device launch) write
    x + 1 on the live prefix and leave the tail untouched, at 3 and 8 of 8
    blocks of 1024 f32 and at 1,000 and 8,160 of 8,160 blocks of 256 f32,
    each form timed at the latter;
14. K10, the segment-sum levels (tools/bench_segsum.py: K5 stripped level
    by level, compiled from K5's own source) on the TPU tool's synthetic
    stream (3,955,712 slots, 1M gaussians) and on phase 8's backward
    stream, each in device ms with its step from the level before, beside
    segment_reduce: s0_prep's output, staging copy and row map bit for bit
    its plain version; s1_scan, s2_gather and s2_nostage within 1e-5 of
    their plain versions and bit for bit K5, also on the seven hard
    streams; then K5, s2_gather and segment_reduce in turns on the
    bench-step stream (device ms);
15. K9, the rasterizer levels (tools/bench_kernel_variants.py: K3 stripped
    level by level, compiled from K3's own source) on phase 4's stream,
    each in device ms with its step from the level before: v0_stage's
    boxes within one pixel of the plain mirror's; v6_full bit for bit K3;
    every other level within 1e-5 of each tile's largest value of its
    plain version, culled by the card's boxes; then, in both modes on the
    mid stream and the hard tiles, v6_full bit for bit K3 and K3 within
    3e-5 of its plain version;
16. the port bench (wgpu_3dgs_core_tpu_torch/bench.py) in-process, its
    headline step and --full, each printing its JSON line, no overflow;
17. bench-shape gradient parity (tools/grad_parity.py: 100,000 gaussians,
    1920x1080, 256x256 crop) within 1e-4 normalized;
18. the ELLIPSE repair: the bench scene in ELLIPSE mode at the capacities
    measure_capacities gives that mode at headroom 1.0, no overflow;
19. the rasterizer's redesign on the bench stream, in turns (device ms,
    median of 3): K3 against K9's v6_full, K4, and K4 on its longest tile
    alone (the tail); the (warp, fragment) pairs the cull keeps and skips and the
    blending warp events.
20. the sharded renderer at D=1 in this process (NCCL, one rank): the
    bench scene's training step (mean(image^2)) through render_sharded,
    its image bit for bit render's, its gradients within 1e-4 normalized
    (bit for bit expected), the K1-K6 launches of that path, and the two
    steps in turns (10 pairs, CUDA events) and their device time by
    kernel kind (profiler): the wrapper's D=1 overhead;
21. the sharded renderer over ranks spawned on this one card by
    parallel/launch.py under gloo (NCCL takes no two ranks on one card;
    gloo stages the collectives through the host): the bench scene at D=2
    (all_to_all) and the mid scene at D=4 (both exchanges), each rank's
    image within 1e-5 of render's and the gradients within 1e-4
    normalized, no overflow, each rank's K1-K6 launches, each strip's
    routed splats, route capacity and fragments, two backward passes
    bit-identical at D=2; its times labelled as one card through gloo,
    not a multi-GPU number; then entry.dryrun_multichip(2) under gloo;
22. the SPZ slice: the bench scene's gaussians through
    Gaussians.from_soa(.., SPZ) with the default options, write_to_file
    into a temporary directory, read_from_file and to_soa, once on the
    native codec (utils/native.py; the phase fails if it did not load) and
    once on the numpy path: every encoded byte and decoded field equal
    between the two but the scales (a code one step apart only on a
    rounding tie, a decoded scale within 1 ulp: numpy's f32 log and exp
    round apart from the C library's), the SpzGaussians read back equal
    to those written; the decoded scene uploaded in the default layout and
    with NORM8 SH and rendered at 1920x1080 at capacities measured on it:
    K1, K2, K3 and K8's unpack launched once each, no overflow, K1 and K2
    bit for bit and K3 within 3e-5 of their plain versions on its stream,
    the unpack held as in phase 11, the image's difference from phase 4's
    printed (SPZ is lossy: a record, not a gate); examples/model.spz at
    256x192 within 1e-4 of render_reference; each step's host time on
    both paths, the file's bytes, the upload and render times, beside the
    card's name and power limit;
23. the training step by stage: the attribution tools (tools/
    profile_components.py, bench_bin.py, bench_bwd.py --newtail,
    bench_nscale.py) in this process on the port bench's scene, 3 calls
    a reading, each printing a line per stage (device ms, operations,
    host enqueue against wall ms, launches, top kinds) and its JSON line,
    beside the card's name and power limit; every stage on the card
    without overflow, the stages that run kernels launching them (bin
    K1, K2; gather and kernel_fwd K3; kernel_fwd_bwd K3, K4; reorder
    K5, K6; step K1-K6; bench_bin's rows K1, expand K1, K2), the
    operations of the step's prefixes (project, color, ..., step) and of
    bench_bin's (counts to ranges) never decreasing; the step stage's
    device ms and operations printed beside phase 9's (a record: phase 9
    profiles this script's own scene, u8 colour and opacity at measured
    capacities);
24. the measurement tools on data: tools/bench_sort_shapes.py,
    bench_irregular_ops.py, bench_reorder.py and bench_reorder2.py in
    this process at the JAX tools' sizes, 10 calls a reading, each
    printing a line per stage and its JSON line; every stage on the card
    with at least one device operation; then tools/scaling_efficiency.py
    at its defaults (65,536 gaussians, 512x512) with 3 timed steps: the
    plain step, the D=8 route build, and NCCL ranks spawned one a card
    (D=1 on this run's one card), which must give efficiency_1dev 1, a
    finite sharding_overhead_1dev and K1-K6 launched on every rank.

Then a JSON line of the kernels (launches on the training step, for K7 and
K8 on phases 11-12, for K9-K11 on the tools' runs of phases 13-15; errors;
"ms" the device time (device_ms; for K7 and K8 the median of 3),
"call_ms" one call by CUDA events, "library_ms" the library call's device
time; and the bound: the least time the card could take for the same
work; K9 and K10 take their full level's, K3's and K5's), the card's name
and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}. Any failure raises and exits nonzero; so
does a machine without a CUDA card. The run uses one card: the first that
CUDA_VISIBLE_DEVICES names, else card 0.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# Before torch starts CUDA: this run, and its contract line, see one card.
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wgpu_3dgs_core_tpu_torch import (  # noqa: E402
    ALL_LAYOUTS,
    BundleKernel,
    Camera,
    Cov3dFormat,
    IrreversibleConfigError,
    KernelBundleBuilder,
    KernelBundleResourceCountError,
    ModelTransform,
    ResourceGroupLayout,
    ShFormat,
    pack,
    unpack,
    GaussianLayout,
    Gaussians,
    GaussiansBuffer,
    GaussianSoA,
    GaussiansSource,
    GaussianTransform,
    TrainableGaussians,
    launch_counts,
    make_train_step,
    measure_capacities,
    render,
    render_gaussians,
    render_reference,
    reset_launch_counts,
)
from wgpu_3dgs_core_tpu_torch import bench as port_bench  # noqa: E402
from wgpu_3dgs_core_tpu_torch.entry import dryrun_multichip  # noqa: E402
from wgpu_3dgs_core_tpu_torch.parallel import (  # noqa: E402
    initialize_multihost,
    make_mesh,
    render_sharded,
)
from wgpu_3dgs_core_tpu_torch.parallel.launch import (  # noqa: E402
    free_port,
    render_step,
    spawn_ranks,
)
from wgpu_3dgs_core_tpu_torch.buffer import GaussianDisplayMode  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import cuda  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import probe as pr  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import variants as va  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import expand as ex  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import unpack_bundle as ub  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops.kernel_bundle import (  # noqa: E402
    tile_plan,
    tile_smem,
)
from wgpu_3dgs_core_tpu_torch.ops import rasterize as ra  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import segreduce as sr  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import sh as shc  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops.transforms import (  # noqa: E402
    cov3d_from_rot_scale,
    unpack_color,
    unpack_cov3d,
    unpack_sh,
)
from wgpu_3dgs_core_tpu_torch.render.train import FIT_HEADROOM  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops.binning import (  # noqa: E402
    CHUNK,
    bbox_table,
    bin_splats,
    bin_splats_attrs,
    count_fragments,
    expand_row_table,
    gaussian_table,
    num_tiles,
    pad_schedule,
    padded_capacity,
    row_capacity,
    row_table,
    sorted_fetch,
    sorted_fetch_plain,
    tile_local_stream,
)
from wgpu_3dgs_core_tpu_torch.ops.projection import (  # noqa: E402
    camera_position,
    project,
)
from wgpu_3dgs_core_tpu_torch.render.renderer import (  # noqa: E402
    project_and_color,
    unpack_gaussians,
)
from wgpu_3dgs_core_tpu_torch.tools import (  # noqa: E402
    bench_bin,
    bench_bwd,
    bench_irregular_ops,
    bench_kernel_variants as k9,
    bench_nscale,
    bench_reorder,
    bench_reorder2,
    bench_segsum as k10,
    bench_sort_shapes,
    expand_tables,
    grad_parity,
    probe_dyngrid as k11,
    profile_components,
    scaling_efficiency,
)
from wgpu_3dgs_core_tpu_torch.tools.stages import (  # noqa: E402
    FORWARD_PREFIX,
)
from wgpu_3dgs_core_tpu_torch.models.spz import read_spz  # noqa: E402
from wgpu_3dgs_core_tpu_torch.utils import native  # noqa: E402
from wgpu_3dgs_core_tpu_torch.utils.numeric import cast_u8  # noqa: E402
from wgpu_3dgs_core_tpu_torch.utils.profiling import (  # noqa: E402
    PROFILER_STATS,
    device_calls,
    device_kernel_ms,
    host_pace_ms,
    kind_ms,
)

MID = dict(n=65_536, width=512, height=512, seed=0)
SPEC = dict(n=2_500, width=256, height=192, seed=3)
FULL = dict(n=1_000_000, width=1920, height=1080, seed=0)
# Half-extents of the means' box and the range of linear scales: the bench
# scene (bench.py synthetic_scene) and the spec scene (tests/test_rowtrim.py
# random_scene).
BENCH_SCENE = dict(half=(3.0, 1.8, 2.0), scales=(0.004, 0.012))
ROWTRIM_SCENE = dict(half=(1.5, 1.0, 1.0), scales=(0.01, 0.08))
BG = (0.1, 0.2, 0.3)
K3_TOL = 3e-5
# K9's stripped levels against their plain versions, relative to each
# tile's largest value: the same f32 alpha decisions, sums in another order.
K9_TOL = 1e-5
SLICE_TOL = 1e-4
# Backward bars, each relative to the largest value of the row or
# parameter compared (tests/test_render.py's gradient bar): K4 and the
# slice's gradients sum in another order than their plain versions; K5's
# plain version sums in f64.
K4_TOL = 1e-4
K5_TOL = 1e-5
GRAD_TOL = 1e-4
# K8: the ROT_SCALE sigma of a bundle against the plain unpack, relative
# to the row's largest |sigma| (csrc/gaussian.cuh rounds each step as
# torch does, so 0 is expected); every other bundle output bit for bit.
SIGMA_TOL = 1e-6
BUNDLE_N = 66_773  # phase 10's items: not a multiple of any block size
BUNDLE_FEW = 1_000  # phase 10's map_add below one tile (4,096 items)
MAP_ADD_N = 1 << 24  # phase 11's map_add beside torch.add
# Back-to-back calls per sample of the host's enqueue (phase 11) and of
# the plain versions of K7, K8 and K11 by CUDA events.
REPS = 20
# Phase 11's model transform (tests/test_torch_ops.py's).
MODEL = ModelTransform(pos=(0.3, -0.2, 0.5), rot=(0.1, 0.2, 0.3, 0.927),
                       scale=(1.2, 0.8, 1.1))
# Phase 14's synthetic stream (the TPU tool's: slots, gaussians, seed),
# phase 16's extra arguments of the port bench (none: its defaults), and
# phase 17's bench-shape gradient parity.
SEGSUM_SYNTHETIC = (3_955_712, 1_000_000, 0)
PORT_BENCH_ARGS: list[str] = []
GRAD_PARITY = dict(gaussians=100_000, width=1920, height=1080, crop=256)
PROFILE_FWD = 10  # forwards (or training steps) per profile measurement
# Phases 20-21: the sharded image against render's (tests/test_sharded.py's
# bar), the sharded and plain steps timed in turns, a spawn's time limit.
SHARDED_TOL = 1e-5
STEP_PAIRS = 10
RANKS_TIMEOUT = 300.0
GRAD_NAMES = ("means", "cov3d", "colour", "opacity", "sh")
# Phase 22: the repo's SPZ example and its render size, and the layout with
# quantized SH the decoded bench scene is uploaded in beside the default.
EXAMPLE_SPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "model.spz")
SPZ_SMALL = dict(width=256, height=192)
SPZ_QUANT_LAYOUT = GaussianLayout(sh=ShFormat.NORM8)
# The SPZ codecs' native and numpy paths hold every encoded byte and every
# decoded field bit for bit but the scales': their log and exp are numpy's
# f32 ones on one path and the C library's logf and expf on the other,
# which round differently by an ulp. So a scale whose code 16 (ln s + 10)
# lies within TIE_TOL of a half (in f64) may encode one step apart, and a
# decoded scale exp(q / 16 - 10) may differ by SCALE_ULPS
# (tests/test_native.py holds that decode within rtol 1e-6).
SPZ_FIELDS = ("positions", "rotations", "alphas", "colors", "shs")
TIE_TOL = 1e-4
SCALE_ULPS = 1
ADAM_STEPS = 3
LEARNING_RATE = 5e-3  # fit()'s default
# The card's published rates (H100 SXM data sheet, at 700 W): device memory
# bytes/s and FP32 flop/s outside the tensor cores. A kernel's bound is the
# larger of the bytes it must move and the flops it must do over them.
HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12
# Flops per (fragment, pixel) pair of the rasterizer, counted in
# csrc/rasterize.cu: evaluating alpha (K3 and K4 alike) is 2 deltas, 11 for
# q, 2 multiplies, 1 exp, 1 min and 3 compares; a blend is 9 more in K3
# (weight, 3 FMAs, 1 - alpha, T) and 47 more in K4 (colour terms, prefix,
# dalpha, the chain to q, the conic and x/y, T).
EVAL_FLOPS, K3_BLEND_FLOPS, K4_BLEND_FLOPS = 20, 9, 47


def fail(msg: str):
    raise RuntimeError(msg)


def draw_scene(n, seed, half, scales):
    """A random scene in bench.py's draw order: means, unit quaternions,
    linear scales, rgb, opacity, then SH (drawn last, so the other draws
    equal those of the scenes it mirrors, which have no SH)."""
    rng = np.random.default_rng(seed)
    means = np.empty((n, 3), np.float32)
    for axis in range(3):
        means[:, axis] = rng.uniform(-half[axis], half[axis], n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = rng.uniform(scales[0], scales[1], (n, 3)).astype(np.float32)
    color = rng.random((n, 3)).astype(np.float32)
    opac = (0.2 + 0.7 * rng.random(n)).astype(np.float32)
    sh = (0.1 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    return means, q, s, color, opac, sh


def to_soa(means, q, scales, color, opac, sh):
    rgba = np.concatenate([color, opac[:, None]], axis=1) * np.float32(255.0)
    return GaussianSoA(rot=q, pos=means, color=cast_u8(rgba), sh=sh,
                       scale=scales)


def cuda_ms(fn, warmup=2, iters=10, reps=1) -> float:
    """Median time of a callable by CUDA events around it, in ms: each of
    ``iters`` samples times ``reps`` back-to-back calls (more than one
    keeps the host's enqueue of a short kernel out of its time)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, warmup=2, iters=10) -> float:
    """Median device time of one call of ``fn``, in ms: torch.profiler over
    ``iters`` back-to-back calls, the device operations (kernels, copies,
    fills) of each call summed, without the host's time between them (the
    way phases 5 and 9 read kernels). utils/profiling.py::device_calls
    splits the trace by call and re-runs a session that lost operations."""
    for _ in range(warmup):
        fn()
    return device_kernel_ms(fn, iters=iters)


def enqueue_ms(fn, reps=10) -> float:
    """Host time to enqueue one call of ``fn`` (no synchronise between
    calls), in ms: the median over 7 runs of ``reps`` calls (one run reads
    up to 2x another on a shared host). Where it is near a kernel's time,
    the host paces it."""
    fn()
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    torch.cuda.synchronize()
    return statistics.median(times)


def kernel_times(kernel, plain, library=None):
    """A kernel row's times, in ms: (its device time, its plain version's
    time by CUDA events, the library call's device time or None, one call
    of the kernel by CUDA events: what a caller pays, the wrapper's host
    work included)."""
    return (device_ms(kernel), cuda_ms(plain),
            None if library is None else device_ms(library), cuda_ms(kernel))


def kernel_inputs(args, cam, max_fragments, max_rows, pad_slack, sh_deg=3,
                  background=BG):
    """The inputs render() hands K1, K2, K14 and K3, made by the port's
    own stages with render()'s capacities; K14's are K2's record form's
    records and the tile sort of its tiles."""
    means, cov6, color, opac, sh = args
    tiles_x, tiles_y = num_tiles(cam.width, cam.height)
    f_cap = -(-max_fragments // CHUNK) * CHUNK
    splats, rgb, op = project_and_color(means, cov6, color, opac, cam, sh=sh,
                                        sh_deg=sh_deg)
    attr_cols = torch.cat([splats.xy.T, splats.conic.T, rgb.T,
                           (op * splats.mask)[None, :]], dim=0)
    table, total_rows = gaussian_table(splats.xy, splats.extent, splats.depth,
                                       splats.mask, attr_cols, tiles_x,
                                       tiles_y)
    r_cap = row_capacity(max_rows)
    rows = ex.expand_rows(table, total_rows, r_cap)
    rtab, total = row_table(rows, total_rows)
    stream, frags, _ = bin_splats_attrs(
        splats.xy, splats.extent, splats.depth, splats.mask, attr_cols,
        tiles_x, tiles_y, f_cap, max_rows=max_rows,
    )
    t_total = tiles_x * tiles_y
    sched = pad_schedule(stream, padded_capacity(f_cap, t_total, pad_slack))
    tile, records = ex.expand_fragment_records(rtab, total, f_cap, tiles_x,
                                               t_total)
    tile_sorted, perm = torch.sort(tile, stable=True)
    return dict(
        k1=(table, total_rows, r_cap),
        k2=(rtab, total, f_cap, tiles_x, t_total),
        k14=(records, perm, tile_sorted, tiles_x, t_total),
        k3=(frags, stream.tile_start, sched.draw_len, background, 9.0, 0),
        total_rows=total_rows, total=total, stream=stream, sched=sched,
        table=table, background=background,
    )


def backward_inputs(inp, seed=0):
    """The inputs render()'s backward hands K4, K5 and K6 for the stream of
    ``inp``, with a random cotangent of K3's output drawn from ``seed``."""
    frags, tile_start, draw_len, bg, cutoff_sq, mode = inp["k3"]
    stream, table = inp["stream"], inp["table"]
    out = ra.rasterize_tiles_fwd(*inp["k3"])
    gen = torch.Generator(device=out.device).manual_seed(seed)
    g_out = torch.randn(out.shape, generator=gen, device=out.device)
    k4 = (frags, tile_start, stream.tile_end - tile_start, draw_len, out,
          g_out, bg, cutoff_sq, mode)
    dfrag = ra.rasterize_tiles_bwd(*k4)
    n = table.ints.shape[1]
    keys, perm = sr.sort_keys(stream.gauss_id, stream.tile_id, tile_start,
                              draw_len, n)
    gid_col = sr.gid_column_sorted(table.ints, n)
    k5 = (keys, perm, dfrag, gid_col, n)
    comp = sr.segment_sums_sorted(*k5)
    return dict(k4=k4, k5=k5, k6=(comp, gid_col, n))


def normalized_err(got, want) -> float:
    """max over rows of max |got - want| / max |want| (rows of zeros
    compare absolutely)."""
    err = (got - want).abs().amax(dim=1)
    scale = want.abs().amax(dim=1)
    return float(torch.where(scale > 0, err / scale, err).max())


def compare_backward(bi):
    """K4, K5, K6 against their plain versions. Returns the max abs errors
    and the normalized errors of K4 and K5."""
    d = ra.rasterize_tiles_bwd(*bi["k4"])
    dp = ra.rasterize_tiles_bwd_plain(*bi["k4"])
    if not torch.isfinite(d).all():
        fail("K4 output is not finite")
    n4 = normalized_err(d, dp)
    if not n4 <= K4_TOL:
        fail(f"K4 rasterize_tiles_bwd differs from its plain version by {n4}")
    c = sr.segment_sums_sorted(*bi["k5"])
    cp = sr.segment_sums_sorted_plain(*bi["k5"])
    n5 = normalized_err(c, cp)
    if not n5 <= K5_TOL:
        fail(f"K5 segment_sums_sorted differs from its plain version by {n5}")
    u = sr.uncompact_columns(*bi["k6"])
    up = sr.uncompact_columns_plain(*bi["k6"])
    if not torch.equal(bits(u), bits(up)):
        fail("K6 uncompact_columns differs from its plain version")
    return ((float((d - dp).abs().max()), float((c - cp).abs().max()), 0.0),
            (n4, n5))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def compare_expand(inp):
    """K1 (both forms) and K2 against their plain versions: every output
    bit for bit. Returns the max abs difference of K1's row stream, of its
    row-table form (ints and attributes) and of K2's float outputs (0 when
    equal)."""
    k1 = ex.expand_rows(*inp["k1"])
    p1 = ex.expand_rows_plain(*inp["k1"])
    if not (torch.equal(k1.ints, p1.ints)
            and torch.equal(bits(k1.attrs), bits(p1.attrs))):
        fail("K1 expand_rows differs from its plain version")
    kt, kt_total = expand_row_table(*inp["k1"])
    pt, pt_total = row_table(p1, inp["k1"][1])
    if not (torch.equal(kt.ints, pt.ints)
            and torch.equal(bits(kt.attrs), bits(pt.attrs))
            and int(kt_total) == int(pt_total) == int(inp["total"])):
        fail("K1 expand_row_table differs from row_table(expand_rows_plain"
             "(...))")
    k2 = ex.expand_fragments_with_attrs(*inp["k2"])
    p2 = ex.expand_fragments_with_attrs_plain(*inp["k2"])
    if not (torch.equal(k2[0], p2[0]) and torch.equal(k2[1], p2[1])
            and torch.equal(bits(k2[2]), bits(p2[2]))):
        fail("K2 expand_fragments_with_attrs differs from its plain version")
    e_table = max(float((kt.attrs - pt.attrs).abs().max()),
                  float((kt.ints.long() - pt.ints.long()).abs().max()))
    return (float((k1.attrs - p1.attrs).abs().max()), e_table,
            float((k2[2] - p2[2]).abs().max()))


def fetch_before(fetched, k14):
    """The render path's fragment side before K14: K2's [A + 1, F] form
    ``fetched`` gathered through the tile sort's permutation,
    tile_local_stream and the gid row's cast (the row form's tiles are
    the record form's, so the sort is K14's)."""
    perm, tile_sorted, tiles_x = k14[1], k14[2], k14[3]
    attrs_sorted = fetched[:, perm]
    return (tile_local_stream(attrs_sorted, tile_sorted, tiles_x),
            attrs_sorted[ex.RECORD_ATTRS].to(torch.int32))


def compare_fetch(inp, stream=None, frags=None):
    """K2's record form and K14 against their plain versions, bit for bit,
    and against what they replace (K2's [A + 1, F] form transposed; the
    gather, tile_local_stream and the cast), two launches of each alike;
    where given, bin_splats_attrs's gid and stream ``frags`` are K14's.
    Returns each one's max abs difference from its plain version (0 when
    equal)."""
    k2, k14 = inp["k2"], inp["k14"]
    tile, rec = ex.expand_fragment_records(*k2)
    p_tile, p_rec = ex.expand_fragment_records_plain(*k2)
    r_tile, r_gid, r_attrs = ex.expand_fragments_with_attrs(*k2)
    again = ex.expand_fragment_records(*k2)
    if not (torch.equal(tile, p_tile) and torch.equal(bits(rec), bits(p_rec))
            and torch.equal(tile, r_tile) and torch.equal(tile, again[0])
            and torch.equal(bits(rec), bits(again[1]))):
        fail("K2 expand_fragment_records differs from its plain version or "
             "from its last launch")
    if not (torch.equal(bits(rec[:, :ex.RECORD_ATTRS]),
                        bits(r_attrs[:ex.RECORD_ATTRS].T))
            and torch.equal(bits(rec[:, ex.RECORD_GID]), r_gid)
            and not rec[:, ex.RECORD_GID + 1:].any()):
        fail("K2 expand_fragment_records is not the row form transposed")
    got = sorted_fetch(*k14)
    want = sorted_fetch_plain(*k14)
    old = fetch_before(r_attrs, k14)
    for name, other in (("its plain version", want), ("its last launch",
                                                      sorted_fetch(*k14)),
                        ("the gather, tile_local_stream and cast", old)):
        if not (torch.equal(bits(got[0]), bits(other[0]))
                and torch.equal(got[1], other[1])):
            fail(f"K14 sorted_fetch differs from {name}")
    if stream is not None and not (
            torch.equal(bits(frags), bits(got[0]))
            and torch.equal(stream.gauss_id, got[1])):
        fail("bin_splats_attrs's stream is not K14's")
    return {"expand_fragment_records": float((rec - p_rec).abs().max()),
            "sorted_fetch": float((got[0] - want[0]).abs().max())}


def compare_k3(inp, tiles=None) -> float:
    out = ra.rasterize_tiles_fwd(*inp["k3"])
    ref = ra.rasterize_tiles_fwd_plain(*inp["k3"], tiles=tiles)
    if tiles is not None:
        out = out[torch.as_tensor(tiles, device=out.device)]
    if not torch.isfinite(out).all():
        fail("K3 output is not finite")
    err = float((out - ref).abs().max())
    if not err <= K3_TOL:
        fail(f"K3 rasterize_tiles_fwd differs from its plain version by {err}")
    return err


def ptxas_kernels(log: str, keys) -> list:
    """(mangled name, ptxas's resource lines) of each kernel in an nvcc -v
    log whose name contains one of ``keys``."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            if any(k in name for k in keys):
                out.append((name, []))
        elif out and name == out[-1][0] and (
                "registers" in ln or "stack frame" in ln):
            out[-1][1].append(ln.split(":", 1)[-1].strip())
    return [(n, " / ".join(lines)) for n, lines in out]


def unit_and_kernel(mangled: str) -> tuple:
    """(source file, kernel) of a mangled kernel name in an anonymous
    namespace: ``_ZN<len>_GLOBAL__N__<hash>_<n>_<file>_cu_<hash><rest>``,
    the rest naming the kernel and its template arguments, which two
    sources compiling the same template share."""
    m = re.match(r"_ZN(\d+)", mangled)
    if m is None or "_GLOBAL__N_" not in mangled:
        return "", mangled
    ns = mangled[m.end():m.end() + int(m.group(1))]
    unit = re.search(r"_\d+_(\w+?)_cu_", ns)
    return (unit.group(1) if unit else ns), mangled[m.end() + len(ns):]


# The production kernels that K9 and K10 compile again from the same
# source (csrc/rasterize_fwd.cuh, csrc/segsum.cuh): their full levels.
SHARED_KERNELS = ("rasterize_fwd_kernelILi6E", "segment_sums_prep_kernel",
                  "segment_sums_kernelILi2E")


def phase_build(bundle_sources):
    """The kernel library, the bundle sources and K11's relocatable
    library, every nvcc started together (one thread each)."""
    with ThreadPoolExecutor(3) as pool:
        lib = pool.submit(cuda.build)
        bundles = pool.submit(cuda.build_sources, bundle_sources)
        probe = pool.submit(pr.build)
        info, infos, pinfo = lib.result(), bundles.result(), probe.result()
    cuda.library()
    regs = [ln.strip() for ln in info.log.splitlines() if "registers" in ln]
    raster = ptxas_kernels(info.log, ("rasterize_", "segment_sums"))
    by_unit: dict = {}
    for name, res in raster:
        unit, kernel = unit_and_kernel(name)
        by_unit.setdefault(kernel, {})[unit] = res
    shared = []
    for key in SHARED_KERNELS:
        (kernel, units), = [(k, u) for k, u in by_unit.items() if key in k]
        if len(units) != 2 or len(set(units.values())) != 1:
            fail(f"{key}: production and variants builds differ in ptxas's "
                 f"resources: {units}")
        shared.append(f"{key} {next(iter(units.values()))}")
    bregs = sorted({int(ln.split("Used ")[1].split(" registers")[0])
                    for b in infos for ln in b.log.splitlines()
                    if "Used " in ln and "registers" in ln})
    print(f"phase 1 build: {info.seconds:.1f} s nvcc sm_90a -> "
          f"{info.path.name}; ptxas: {' | '.join(regs)}; "
          f"{len(set(bundle_sources))} bundle sources in "
          f"{max(b.seconds for b in infos):.1f} s (registers {bregs}); "
          f"K11 relocatable (-rdc, cudadevrt) in {pinfo.seconds:.1f} s",
          flush=True)
    print("phase 1 rasterizer and segment-sum kernels (ptxas): "
          + "; ".join(f"{name}: {info}" for name, info in raster), flush=True)
    print("phase 1 K3 and K5 built twice from one source (rasterize.cu and "
          "segreduce.cu; variants.cu, K9's v6_full and K10's s2_gather), "
          "the same ptxas resources: " + "; ".join(shared), flush=True)


def mid_scene(device):
    """The mid scene: its camera, render arguments, measured capacities
    and the kernels' inputs for its stream."""
    cfg = MID
    soa = to_soa(*draw_scene(cfg["n"], cfg["seed"], **BENCH_SCENE))
    buf = GaussiansBuffer.new(soa, GaussianLayout(), device)
    cam = Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                         width=cfg["width"], height=cfg["height"], fov_y=0.9)
    args = unpack_gaussians(buf.data)
    caps = measure_capacities(args[0], args[1], args[3], cam)
    return cam, args, caps, kernel_inputs(args, cam, *caps, pad_slack=1.0)


def phase_kernels(mid):
    cfg = MID
    inp = mid[3]
    e1, et, e2 = compare_expand(inp)
    e_fetch = compare_fetch(inp, inp["stream"], inp["k3"][0])
    e3 = compare_k3(inp)
    print(f"phase 2 kernels vs plain ({cfg['n']} gaussians, "
          f"{cfg['width']}x{cfg['height']}, {int(inp['total'])} fragments): "
          f"K1 bit-identical (both forms), K2 bit-identical (both forms), "
          f"K14 bit-identical (and the gather + tile_local_stream + cast "
          f"it replaces), K3 max abs err {e3:.3g} (tol {K3_TOL})",
          flush=True)
    return (e1, et, e2, e3), e_fetch


def phase_spec(device):
    cfg = SPEC
    soa = to_soa(*draw_scene(cfg["n"], cfg["seed"], **ROWTRIM_SCENE))
    buf = GaussiansBuffer.new(soa, GaussianLayout(), device)
    cam = Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                         width=cfg["width"], height=cfg["height"], fov_y=0.9)
    res = render_gaussians(buf, cam, GaussianTransform(sh_deg=3),
                           background=BG)
    means, cov6, color, opac, sh = unpack_gaussians(buf.data)
    ref = render_reference(means, cov6, color, opac, cam, sh=sh, sh_deg=3,
                           background=BG)
    if bool(res.overflow):
        fail("slice vs spec: unexpected overflow")
    err = float((res.image - ref).abs().max())
    if not err <= SLICE_TOL:
        fail(f"slice differs from render_reference by {err}")
    print(f"phase 3 slice vs spec ({cfg['n']} gaussians, {cfg['width']}x"
          f"{cfg['height']}, sh_deg 3): max abs err {err:.3g} "
          f"(tol {SLICE_TOL})", flush=True)
    return err


def bench_scene(device):
    """The bench scene as a GaussiansBuffer on ``device``, its camera, the
    unpacked render arguments and render()'s keyword arguments (measured
    capacities, pad_slack 0.65)."""
    cfg = FULL
    soa = to_soa(*draw_scene(cfg["n"], cfg["seed"], **BENCH_SCENE))
    buf = GaussiansBuffer.new(soa, GaussianLayout(), device)
    cam = Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                         width=cfg["width"], height=cfg["height"], fov_y=0.9)
    args = unpack_gaussians(buf.data)
    max_fragments, max_rows = measure_capacities(args[0], args[1], args[3],
                                                 cam)
    kw = dict(background=(0.0, 0.0, 0.0), max_fragments=max_fragments,
              max_rows=max_rows, pad_slack=0.65)
    return soa, buf, cam, args, kw


def phase_full(device, errs, scene):
    cfg = FULL
    _, buf, cam, args, kw = scene
    max_fragments, max_rows = kw["max_fragments"], kw["max_rows"]
    pad_slack = kw["pad_slack"]
    transform = GaussianTransform(sh_deg=3)

    def forward():
        return render_gaussians(buf, cam, transform, **kw)

    inp = kernel_inputs(args, cam, max_fragments, max_rows, pad_slack,
                        background=kw["background"])
    e1, et, e2 = compare_expand(inp)
    e_fetch = compare_fetch(inp, inp["stream"], inp["k3"][0])
    lens = inp["k3"][2]
    densest = int(torch.argmax(lens))
    rng = np.random.default_rng(0)
    picks = rng.choice(lens.shape[0], 63, replace=False).tolist()
    tiles = sorted(set(picks) | {densest})
    e3 = compare_k3(inp, tiles=tiles)
    errs = tuple(map(max, errs, (e1, et, e2, e3)))

    torch.cuda.synchronize(device)
    reset_launch_counts()
    res = forward()
    torch.cuda.synchronize(device)
    launches = launch_counts()
    ran = {k: v for k, v in launches.items()
           if k in FORWARD_KERNELS + SH_KERNELS[:1]}
    if min(ran.values()) < 1:
        fail(f"a kernel of the forward path did not run: {launches}")
    if bool(res.overflow):
        fail("full-size render overflowed its capacities")
    if tuple(res.image.shape) != (cfg["height"], cfg["width"], 3):
        fail(f"bad image shape {tuple(res.image.shape)}")
    if not (torch.isfinite(res.image).all()
            and torch.isfinite(res.transmittance).all()):
        fail("full-size image is not finite")
    rows, frags = int(inp["total_rows"]), int(inp["total"])

    fwd_ms = cuda_ms(forward)
    k1, k2, k3, k14 = inp["k1"], inp["k2"], inp["k3"], inp["k14"]
    ms = {
        "expand_rows": kernel_times(lambda: ex.expand_rows(*k1),
                                    lambda: ex.expand_rows_plain(*k1)),
        "expand_row_table": kernel_times(
            lambda: expand_row_table(*k1),
            lambda: row_table(ex.expand_rows_plain(*k1), k1[1])),
        "expand_fragments": kernel_times(
            lambda: ex.expand_fragments_with_attrs(*k2),
            lambda: ex.expand_fragments_with_attrs_plain(*k2)),
        "expand_fragment_records": kernel_times(
            lambda: ex.expand_fragment_records(*k2),
            lambda: ex.expand_fragment_records_plain(*k2)),
        "sorted_fetch": kernel_times(lambda: sorted_fetch(*k14),
                                     lambda: sorted_fetch_plain(*k14)),
        "rasterize_fwd": kernel_times(
            lambda: ra.rasterize_tiles_fwd(*k3),
            lambda: ra.rasterize_tiles_fwd_plain(*k3)),
    }
    row_turns = in_turns({
        "expand_row_table": lambda: expand_row_table(*k1),
        "expand_rows + row_table": lambda: row_table(ex.expand_rows(*k1),
                                                     k1[1]),
    })
    fetched = ex.expand_fragments_with_attrs(*k2)[2]
    fetch_turns = in_turns({
        "sorted_fetch": lambda: sorted_fetch(*k14),
        "gather + tile_local_stream + cast": lambda: fetch_before(fetched,
                                                                  k14),
    })
    del fetched
    mpix = cfg["width"] * cfg["height"] / fwd_ms / 1e3
    print(f"phase 4 full slice ({cfg['n']} gaussians, {cfg['width']}x"
          f"{cfg['height']}, sh_deg 3, pad_slack {pad_slack}): capacities "
          f"{max_fragments} fragments / {max_rows} rows, live {frags} "
          f"fragments / {rows} rows, overflow False, launches {ran}, "
          f"K3 on {len(tiles)} tiles incl. densest {densest} "
          f"({int(lens[densest])} fragments) max abs err {e3:.3g}; forward "
          f"{fwd_ms:.3f} ms ({mpix:.1f} Mpix/s); device/call/plain ms "
          + ", ".join(f"{k} {t[0]:.4f}/{t[3]:.4f}/{t[1]:.3f}"
                      for k, t in ms.items())
          + "; K1's row table in turns (device ms, median of 3): "
          + ", ".join(f"{k} {v:.4f}" for k, v in row_turns.items())
          + "; K14 in turns: "
          + ", ".join(f"{k} {v:.4f}" for k, v in fetch_turns.items())
          + "; K2's record form and K14 bit for bit their plain versions "
          "and what they replace, two launches alike", flush=True)
    return ms, errs, e_fetch, forward, fwd_ms, inp


def ms_by_kind(fn):
    """Device ms of one call of ``fn`` by kernel kind, largest first
    (torch.profiler over PROFILE_FWD back-to-back calls, split by
    utils/profiling.py::device_calls, kinds by its KERNEL_KINDS), and the
    operations of a call."""
    calls = device_calls(fn, iters=PROFILE_FWD)
    return kind_ms(calls), len(calls[0])


def phase_profile(fn, phase: str, what: str):
    """Where the time of ``fn`` (a bench-scene forward or training step)
    goes: the host's enqueue time against the wall time of back-to-back
    calls (host-bound when they are equal), and the device kernels per
    call by torch.profiler. Busy share = device kernel time / wall time.
    Returns (device kernel ms, device kernels) per call."""
    enqueue_ms, wall_ms = host_pace_ms(fn, iters=PROFILE_FWD)
    per_call, n_ops = ms_by_kind(fn)
    device_ms = sum(per_call.values())
    print(f"phase {phase} profile ({PROFILE_FWD} back-to-back {what}s): "
          f"host enqueue {enqueue_ms:.3f} ms/{what}, wall {wall_ms:.3f} "
          f"ms/{what}; {n_ops} device kernels and "
          f"{device_ms:.3f} ms of device kernel time per {what} (busy "
          f"share {device_ms / wall_ms:.2f}); ms/{what} by kind: "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_call.items()),
          flush=True)
    return device_ms, n_ops


def leaves(args):
    return [t.detach().clone().requires_grad_(True) for t in args]


def grads_of(args, cam, target, **kw):
    """Gradients of sum((render - target)^2) w.r.t. every argument."""
    res = render(*args[:4], cam, sh=args[4], sh_deg=3, **kw)
    if bool(res.overflow):
        fail("backward scene overflowed its capacities")
    loss = torch.sum((res.image - target) ** 2)
    return torch.autograd.grad(loss, args)


def k5_hard_streams(device):
    """K5 on the streams its design finds hard (tools/bench_segsum.py::
    hard_streams): within K5_TOL of its plain version, exact zeros in the
    rows no run reaches, the same bits from two launches. Returns the max
    abs and normalized errors."""
    err = norm = 0.0
    for name, st in k10.hard_streams(device=device).items():
        keys, _, _, gid_col, n = st
        got = sr.segment_sums_sorted(*st)
        again = sr.segment_sums_sorted(*st)
        want = sr.segment_sums_sorted_plain(*st)
        n5 = normalized_err(got, want)
        if not n5 <= K5_TOL:
            fail(f"K5 on the {name} stream differs from its plain version "
                 f"by {n5}")
        if got[:, ~torch.isin(gid_col, keys[keys < n])].any():
            fail(f"K5 on the {name} stream wrote a row no run reaches")
        if not equal_bits(got, again):
            fail(f"two K5 launches on the {name} stream differ")
        err, norm = max(err, abs_err(got, want)), max(norm, n5)
    return err, norm


def with_mode(k3, mode: int):
    """K3's arguments with the display mode replaced."""
    return k3[:5] + (mode,)


def k4_inputs(k3, seed: int):
    """K4's arguments for K3's ``k3`` (every fragment drawn as K3 drew it),
    with K3's output and a cotangent drawn from ``seed``."""
    frags, start, draw_len, bg, cutoff_sq, mode = k3
    out = ra.rasterize_tiles_fwd(*k3)
    gen = torch.Generator(device=out.device).manual_seed(seed)
    g_out = torch.randn(out.shape, generator=gen, device=out.device)
    return (frags, start, draw_len, draw_len, out, g_out, bg, cutoff_sq,
            mode)


def hard_tile_cases(device):
    """The hard tiles of the pixel-box cull (tools/bench_kernel_variants.py
    ::hard_tiles), in SPLAT and ELLIPSE mode: [(name, K3's arguments)]."""
    return [(f"{name}/{'ELLIPSE' if mode else 'SPLAT'}",
             (frags, start, lens, BG, 9.0, mode))
            for name, (frags, start, lens) in k9.hard_tiles(device).items()
            for mode in (0, 1)]


def check_k4(name, k4):
    """K4 within K4_TOL of its plain version, and two launches
    bit-identical. Returns the max normalized error."""
    got = ra.rasterize_tiles_bwd(*k4)
    if not equal_bits(got, ra.rasterize_tiles_bwd(*k4)):
        fail(f"two K4 launches on {name} differ")
    if not torch.isfinite(got).all():
        fail(f"K4 output on {name} is not finite")
    n_plain = normalized_err(got, ra.rasterize_tiles_bwd_plain(*k4))
    if not n_plain <= K4_TOL:
        fail(f"K4 on {name} differs from its plain version by {n_plain}")
    return n_plain


def phase_backward_kernels(device, mid):
    cfg = MID
    cam, args, caps, inp = mid
    errs, (n4, n5) = compare_backward(backward_inputs(inp))
    hard_err, hard_norm = k5_hard_streams(device)
    errs = (errs[0], max(errs[1], hard_err), errs[2])
    # K4 in both modes on the mid stream and on the hard tiles: within
    # K4_TOL of its plain version, two launches bit-identical.
    cases = [(f"mid/{mode}", with_mode(inp["k3"], mode))
             for mode in (0, 1)] + hard_tile_cases(device)
    k4_plain = max(check_k4(name, k4_inputs(k3, seed=3))
                   for name, k3 in cases)

    # Two backward passes of the whole slice, bit for bit.
    x = leaves(args)
    gen = torch.Generator(device=device).manual_seed(1)
    target = torch.rand((cfg["height"], cfg["width"], 3), generator=gen,
                        device=device)
    kw = dict(background=BG, max_fragments=caps[0], max_rows=caps[1])
    first = grads_of(x, cam, target, **kw)
    second = grads_of(x, cam, target, **kw)
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(first, second)):
        fail("two backward passes of the slice differ")
    print(f"phase 6 backward kernels vs plain ({cfg['n']} gaussians, "
          f"{cfg['width']}x{cfg['height']}, {int(inp['total'])} fragments, "
          f"random cotangent): K4 max abs err {errs[0]:.3g}, normalized "
          f"{n4:.3g} (tol {K4_TOL}), in both modes on the mid stream and "
          f"the {len(k9.HARD_TILES)} hard tile sets {k4_plain:.3g}, two "
          f"launches bit-identical; K5 max abs err {errs[1]:.3g}, "
          f"normalized {n5:.3g} (tol {K5_TOL}), on the "
          f"{len(k10.HARD_STREAMS)} hard streams {hard_norm:.3g}, unreached "
          f"rows zero, two launches bit-identical; K6 bit-identical; two "
          f"backward passes bit-identical", flush=True)
    return errs


def phase_spec_grads(device):
    cfg = SPEC
    means, q, scales, color, opac, sh = (
        torch.from_numpy(a).to(device)
        for a in draw_scene(cfg["n"], cfg["seed"], **ROWTRIM_SCENE))
    cam = Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                         width=cfg["width"], height=cfg["height"], fov_y=0.9)
    gen = torch.Generator(device=device).manual_seed(2)
    target = torch.rand((cfg["height"], cfg["width"], 3), generator=gen,
                        device=device)

    def grads(renderer):
        x = leaves((means, q, scales, color, opac, sh))
        cov6 = cov3d_from_rot_scale(x[1], x[2])
        img = renderer(x[0], cov6, x[3], x[4], x[5])
        loss = torch.sum((img - target) ** 2)
        return torch.autograd.grad(loss, x)

    def tiled(m, c6, co, o, s):
        res = render(m, c6, co, o, cam, sh=s, sh_deg=3, background=BG)
        if bool(res.overflow):
            fail("spec-scene render overflowed")
        return res.image

    mine = grads(tiled)
    ref = grads(lambda m, c6, co, o, s: render_reference(
        m, c6, co, o, cam, sh=s, sh_deg=3, background=BG))
    names = ("means", "quats", "scales", "color", "opacity", "sh")
    errs = {}
    for name, a, b in zip(names, mine, ref):
        if not torch.isfinite(a).all():
            fail(f"slice gradient of {name} is not finite")
        errs[name] = float((a - b).abs().max() / b.abs().max())
    if not max(errs.values()) <= GRAD_TOL:
        fail(f"slice gradients differ from render_reference's: {errs}")
    print(f"phase 7 slice gradients vs autograd of render_reference "
          f"({cfg['n']} gaussians, {cfg['width']}x{cfg['height']}, sh_deg "
          f"3, loss sum((image - target)^2), full image): normalized max "
          f"err " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {GRAD_TOL})", flush=True)


def rasterizer_pairs(frags, tile_start, draw_len, cutoff_sq=9.0, mode=0):
    """(evaluated, blended) (fragment, pixel) pairs of this stream: K3 and
    K4 evaluate a fragment at a pixel while the pixel's transmittance
    before it is above T_MIN, and blend it there when it is kept; and the
    blending warp events, the (warp, fragment) pairs of K3's and K4's warps
    with a pixel of the warp blending. Counted with the plain version's
    arithmetic."""
    dev = frags.device
    p = torch.arange(ra.PIX, device=dev)
    px = (p % 16).float() + 0.5
    py = torch.div(p, 16, rounding_mode="floor").float() + 0.5
    lanes = k9.warp_pixels().to(dev).flatten()
    evaluated = blended = events = 0
    tiles = torch.arange(tile_start.shape[0], device=dev)
    for _, valid, idx in ra._tile_batches(tile_start, draw_len, tiles):
        alpha, ok = ra._frag_alpha(frags[:, idx][..., None], px, py,
                                   cutoff_sq, mode)
        keep = ok & valid[..., None]
        t = torch.cumprod(1.0 - torch.where(keep, alpha, 0.0), dim=1)
        t_before = torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], dim=1)
        live = (t_before > ra.T_MIN) & valid[..., None]
        evaluated += int(live.sum())
        blends = live & keep
        blended += int(blends.sum())
        by_warp = blends[..., lanes].reshape(*blends.shape[:2], 8, 32)
        events += int(by_warp.any(dim=-1).sum())
    return evaluated, blended, events


def bound(nbytes: float, flops: float):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the flops over the FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_flops = flops / FP32_FLOPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops,
                                                           "operations")


def kernel_bounds(inp, bi):
    """Each kernel's bound from this run's inputs: every input byte read
    once and every output byte written once (where a kernel reads only
    the live or drawn part, that part), and the flops this data needs."""
    f32 = 4
    table, total_rows, r_cap = inp["k1"]
    rtab, total, f_cap, _, t_total = inp["k2"]
    frags, tile_start, draw_len = inp["k3"][:3]
    n = table.ints.shape[1]
    rows = rtab.ints.shape[1]
    drawn = int(draw_len.sum())
    n_live = int((table.ints[ex.TAB_CNT] > 0).sum())
    pix_block = t_total * 4 * ra.PIX * f32  # one [T, 4, 256] array
    evaluated, blended, events = rasterizer_pairs(frags, tile_start,
                                                  draw_len)
    return {
        "expand_rows": bound(
            f32 * ((ex.TAB_ROWS + table.attrs.shape[0]) * n + 1)
            + f32 * (ex.ROW_INTS + table.attrs.shape[0]) * r_cap, 0),
        # The table's rows it reads once (all but the counts: offsets,
        # x0, y0, span, gid and the 10 attribute rows), and 60 B a slot:
        # the kernel's 5 int and 9 f32 rows, the cumsum's offsets.
        "expand_row_table": bound(
            f32 * ((ex.TAB_ROWS - 1 + table.attrs.shape[0]) * n + 1)
            + f32 * (ex.TAB_ROWS + rtab.attrs.shape[0]) * r_cap, 0),
        "expand_fragments": bound(
            f32 * ((ex.TAB_ROWS + rtab.attrs.shape[0]) * rows + 1)
            + f32 * (2 + rtab.attrs.shape[0] + 1) * f_cap, 0),
        # The row form's reads; the tile and the 48-B record a slot.
        "expand_fragment_records": bound(
            f32 * ((ex.TAB_ROWS + rtab.attrs.shape[0]) * rows + 1)
            + f32 * (1 + ex.RECORD_WIDTH) * f_cap, 0),
        # A live slot reads its permutation entry, tile and record (8 + 4
        # + 48 B), a padding slot the first two; each writes its 9 floats
        # and gid (40 B).
        "sorted_fetch": bound((8 + 4 + 40) * f_cap + f32 * ex.RECORD_WIDTH
                              * min(int(total), f_cap), 0),
        "rasterize_fwd": bound(
            ra.FRAG_ROWS * f32 * drawn + 2 * f32 * t_total + pix_block,
            EVAL_FLOPS * evaluated + K3_BLEND_FLOPS * blended),
        "rasterize_bwd": bound(
            ra.FRAG_ROWS * f32 * drawn + 3 * f32 * t_total + 2 * pix_block
            + ra.FRAG_ROWS * f32 * frags.shape[1],
            EVAL_FLOPS * evaluated + K4_BLEND_FLOPS * blended),
        "segment_sums": bound(
            f32 * n + (4 + 8 + sr.GRAD_ROWS * f32) * drawn
            + sr.GRAD_ROWS * f32 * n, sr.GRAD_ROWS * drawn),
        "uncompact": bound(
            f32 * n + sr.GRAD_ROWS * f32 * n_live + sr.GRAD_ROWS * f32 * n,
            0),
    }, dict(evaluated=evaluated, blended=blended, drawn=drawn,
            n_live=n_live, warp_events=events)


def library_calls(bi):
    """The one PyTorch call computing K5's function (segment_reduce over
    the drawn slots, their gradient rows gathered in key order first) and
    K6's (index_copy_ onto zeros), on the same inputs."""
    n = bi["k5"][4]
    comp, gid_col = bi["k6"][0], bi["k5"][3]
    n_live = int((gid_col < n).sum())
    live_gids = gid_col[:n_live].long()
    live_comp = comp[:, :n_live]
    k5 = k10.segment_reduce_call(*bi["k5"])

    def k6():
        return torch.zeros((sr.GRAD_ROWS, n), device=comp.device).index_copy_(
            1, live_gids, live_comp)

    got5 = k5().T
    want5 = sr.segment_sums_sorted_plain(*bi["k5"])
    if not normalized_err(got5, want5) <= K5_TOL:
        fail("segment_reduce does not compute K5's function")
    if not torch.equal(k6(), sr.uncompact_columns_plain(*bi["k6"])):
        fail("index_copy_ does not compute K6's function")
    return k5, k6


def phase_train(device, scene, inp, fwd_ms, errs):
    cfg = FULL
    soa, _, cam, args, kw = scene
    x = leaves(args)

    def step():
        res = render(*x[:4], cam, sh=x[4], sh_deg=3, **kw)
        loss = torch.mean(res.image ** 2)
        return res, loss, torch.autograd.grad(loss, x)

    torch.cuda.synchronize(device)
    reset_launch_counts()
    res, loss, grads = step()
    torch.cuda.synchronize(device)
    # K1's row-stream form and K2's row form are reported as counted: the
    # step runs K1's row-table form and K2's record form.
    launches = {k: v for k, v in launch_counts().items()
                if k in ("expand_rows", "expand_fragments") + RENDER_KERNELS
                + SH_KERNELS}
    if min(launches.get(k, 0) for k in RENDER_KERNELS + SH_KERNELS) < 1:
        fail(f"a kernel of the training step did not run: {launches}")
    if bool(res.overflow):
        fail("training step overflowed its capacities")
    if not (torch.isfinite(loss) and all(torch.isfinite(g).all()
                                         for g in grads)):
        fail("training-step gradients are not finite")
    step_ms = cuda_ms(step)

    # Three Adam steps of make_train_step at the same size.
    params = TrainableGaussians.from_soa(soa, device)
    means, cov6, _, opacity, _ = params.constrained()
    caps = dict(zip(("max_fragments", "max_rows"), measure_capacities(
        means, cov6, opacity, cam, headroom=FIT_HEADROOM)))
    opt = torch.optim.Adam(params.parameters(), lr=LEARNING_RATE)
    target = torch.zeros((cfg["height"], cfg["width"], 3), device=device)
    train_step = make_train_step(cam, target, opt, sh_deg=3,
                                 background=kw["background"],
                                 pad_slack=kw["pad_slack"], **caps)
    losses = []
    for _ in range(ADAM_STEPS):
        loss_t, overflow = train_step(params)
        if bool(overflow):
            fail("an Adam step overflowed its capacities")
        losses.append(float(loss_t))
    if not all(np.isfinite(losses)):
        fail(f"Adam losses are not finite: {losses}")

    # The backward kernels on the bench stream: against their plain
    # versions, and timed beside them and the library calls.
    bi = backward_inputs(inp)
    e_full, (n4, n5) = compare_backward(bi)
    errs = errs[:4] + tuple(max(a, b) for a, b in zip(errs[4:], e_full))
    # K4 on the bench stream and the hard tiles: within K4_TOL of its
    # plain version, two launches bit-identical.
    n_hard = max(check_k4(name, k4_args)
                 for name, k4_args in [("the bench stream", bi["k4"])] + [
                     (name, k4_inputs(k3, seed=4))
                     for name, k3 in hard_tile_cases(device)])
    lib5, lib6 = library_calls(bi)
    k4, k5, k6 = bi["k4"], bi["k5"], bi["k6"]
    ms = {
        "rasterize_bwd": kernel_times(
            lambda: ra.rasterize_tiles_bwd(*k4),
            lambda: ra.rasterize_tiles_bwd_plain(*k4)),
        "segment_sums": kernel_times(
            lambda: sr.segment_sums_sorted(*k5),
            lambda: sr.segment_sums_sorted_plain(*k5), lib5),
        "uncompact": kernel_times(
            lambda: sr.uncompact_columns(*k6),
            lambda: sr.uncompact_columns_plain(*k6), lib6),
    }
    mpix = cfg["width"] * cfg["height"] / step_ms / 1e3
    print(f"phase 8 training step ({cfg['n']} gaussians, {cfg['width']}x"
          f"{cfg['height']}, sh_deg 3, pad_slack {kw['pad_slack']}, loss "
          f"mean(image^2), grads of means/cov3d/colour/opacity/sh): "
          f"overflow False, gradients finite, launches {launches}; "
          f"forward+backward {step_ms:.3f} ms ({mpix:.1f} Mpix/s) against "
          f"forward {fwd_ms:.3f} ms; {ADAM_STEPS} Adam steps (lr "
          f"{LEARNING_RATE}, capacities {caps['max_fragments']} / "
          f"{caps['max_rows']}) losses "
          + ", ".join(f"{v:.6g}" for v in losses)
          + f"; bench stream K4 normalized err {n4:.3g}, K5 {n5:.3g}, K6 "
          f"bit-identical; K4 within {n_hard:.3g} of its plain version on "
          f"the bench stream and the hard tiles, two launches "
          f"bit-identical; device/call/plain/library "
          f"device ms "
          + ", ".join(f"{k} {a:.4f}/{d:.4f}/{b:.3f}/{c:.4f}" if c is not None
                      else f"{k} {a:.4f}/{d:.4f}/{b:.3f}"
                      for k, (a, b, c, d) in ms.items()),
          flush=True)
    return launches, ms, errs, lambda: step()[2], bi


def phase_sh_color(scene):
    """K12 on the bench scene's own colour, sh and means (see phase 8 in
    the module's docstring). Returns the max abs errors, the times and the
    bounds: 216 B a gaussian forward (means, base and sh read, rgb
    written) and 420 B backward (the same and d_rgb read; d_base, d_sh and
    d_means written); its few hundred flops a gaussian take far less."""
    _, _, cam, args, _ = scene
    means, _, color, _, sh = args
    n = means.shape[0]
    gen = torch.Generator(device=means.device).manual_seed(12)
    d_rgb = torch.randn((n, 3), generator=gen, device=means.device)
    fwd = (color, sh, means, camera_position(cam), 3, False)
    bwd = fwd + (d_rgb,)
    rgb, want = shc.sh_color_fwd(*fwd), shc.sh_color_plain(*fwd)
    if not torch.equal(bits(rgb), bits(want)):
        fail("K12 sh_color_fwd differs from its plain version")
    got, ref = shc.sh_color_bwd(*bwd), shc.sh_color_bwd_plain(*bwd)
    if not all(torch.isfinite(g).all() for g in got):
        fail("K12 sh_color_bwd output is not finite")
    if not torch.equal(bits(got[0]), bits(ref[0])):
        fail("K12 sh_color_bwd's d_base differs from the closed form")
    wide = [t.double() for t in (color, sh, means, d_rgb)]
    truth = shc.sh_color_bwd_plain(*wide[:3], *fwd[3:], wide[3])
    # The gaussians whose colour gate (unclamped colour >= 0) is the same
    # in float32 and float64.
    gates = [c + shc.eval_sh(s, shc.view_dirs_from(m, fwd[3]), 3) >= 0.0
             for c, s, m in ((color, sh, means), wide[:3])]
    same = (gates[0] == gates[1]).all(-1)

    def errs_64(grads):  # (d_sh, d_means) against the float64 closed form
        return [normalized_err(g.reshape(n, -1)[same].double(),
                               t.reshape(n, -1)[same])
                for g, t in zip(grads[1:], truth[1:])]

    (n_sh, n_means), (p_sh, p_means) = errs_64(got), errs_64(ref)
    means_tol = max(GRAD_TOL, 2 * p_means)
    if not (n_sh <= GRAD_TOL and n_means <= means_tol):
        fail(f"K12 sh_color_bwd differs from the float64 closed form by "
             f"{n_sh} (d_sh), {n_means} (d_means; the float32 closed form "
             f"by {p_means})")
    errs = {"sh_color_fwd": 0.0,
            "sh_color_bwd": max(float((g - r).abs().max())
                                for g, r in zip(got, ref))}
    ms = {"sh_color_fwd": kernel_times(lambda: shc.sh_color_fwd(*fwd),
                                       lambda: shc.sh_color_plain(*fwd)),
          "sh_color_bwd": kernel_times(lambda: shc.sh_color_bwd(*bwd),
                                       lambda: shc.sh_color_bwd_plain(*bwd))}
    bounds = {"sh_color_fwd": bound(216 * n, 0),
              "sh_color_bwd": bound(420 * n, 0)}
    print(f"phase 8 K12 ({n} gaussians, sh_deg 3): sh_color_fwd bit for "
          f"bit its plain version; sh_color_bwd d_base bit for bit, against "
          f"the float64 closed form d_sh normalized err {n_sh:.3g} (tol "
          f"{GRAD_TOL}; float32 closed form {p_sh:.3g}), d_means "
          f"{n_means:.3g} (tol {means_tol:.3g}; float32 closed form "
          f"{p_means:.3g}; {n - int(same.sum())} gaussians gated "
          f"otherwise in float64 left out); device/call/plain ms, bound ms "
          + ", ".join(f"{k} {t[0]:.4f}/{t[3]:.4f}/{t[1]:.3f}, "
                      f"{bounds[k][0]:.4f} ({bounds[k][0] / t[0]:.0%})"
                      for k, t in ms.items()), flush=True)
    return errs, ms, bounds


# ------------------------------------------------ phases 10-12: K8, K7


def _map_add(a, b, out, *, scale=1.0):
    out[...] = (a[...] + b[...]) * scale


def _sum_prod(a, b, c, s, p):
    s[...] = a[...] + b[...] + c[...]
    p[...] = a[...] * b[...] * c[...]


def _times(k):
    def body(x, out):
        out[...] = x[...] * float(k)
    return body


def _cov3d(c, out, *, config):
    out[...] = unpack_cov3d(c[...], rot_scale=config)


def _casts(h, q, c, oh, oq, oc):
    oh[...] = unpack_cov3d(h[...], rot_scale=False)
    oq[...] = unpack_sh(q[...], q.shape[0], q.device).reshape(-1, 45)
    oc[...] = unpack_color(c[...])


def _widen(x, out):
    out[...] = x[...].float()


def _times_cuda(k, width):
    return BundleKernel(cuda=f"""
__device__ void times{k}(const float* x, float* out) {{
  for (int j = 0; j < {width}; ++j) out[j] = __fmul_rn(x[j], {k}.0f);
}}""", entry=f"times{k}", plain=_times(k))


MAP_ADD = BundleKernel(cuda="""
__device__ void map_add(const float* a, const float* b, float* out) {
  out[0] = __fmul_rn(__fadd_rn(a[0], b[0]), scale);
}""", entry="map_add", plain=_map_add)
SUM_PROD = BundleKernel(cuda="""
__device__ void sum_prod(const float* a, const float* b, const float* c,
                         float* s, float* p) {
  s[0] = __fadd_rn(__fadd_rn(a[0], b[0]), c[0]);
  p[0] = __fmul_rn(__fmul_rn(a[0], b[0]), c[0]);
}""", entry="sum_prod", plain=_sum_prod)
COV3D = BundleKernel(cuda="""
__device__ void cov3d(const float* c, float* out) {
  if (config) gs::unpack_cov3d_rot_scale(c, out);
  else gs::unpack_cov3d_single(c, out);
}""", entry="cov3d", plain=_cov3d)
WIDEN = BundleKernel(cuda="""
__device__ void widen(const uint8_t* x, float* out) {
  for (int j = 0; j < 3; ++j) out[j] = float(x[j]);
}""", entry="widen", plain=_widen)
CASTS = BundleKernel(cuda="""
__device__ void casts(const __half* h, const int8_t* q, const uint8_t* c,
                      float* oh, float* oq, float* oc) {
  gs::unpack_cov3d_half(h, oh);
  gs::unpack_sh_norm8(q, oq);
  gs::unpack_color(c, oc);
}""", entry="casts", plain=_casts)


def _map_add_builder():
    return (KernelBundleBuilder().label("array map add")
            .resource_layout(ResourceGroupLayout("inputs", arity=2))
            .kernel(MAP_ADD).output(1))


def bundle_cases(device):
    """Phase 10's bundles, the shapes of tests/test_kernel_bundle.py at
    BUNDLE_N items, and a map_add over fewer items than one tile: (name,
    bundle, resources on the card, count)."""
    n = BUNDLE_N
    rng = np.random.default_rng(10)

    def f32(*shape):
        return torch.from_numpy(
            rng.normal(size=(n, *shape)).astype(np.float32)).to(device)

    a, b, c, x8 = f32(), f32(), f32(), f32(8)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    rot_scale = np.concatenate(
        [q / np.linalg.norm(q, axis=1, keepdims=True),
         rng.uniform(0.004, 0.012, (n, 3)).astype(np.float32)], axis=1)
    cov7 = torch.from_numpy(rot_scale).to(device)
    half = f32(6).half()
    norm8 = torch.from_numpy(rng.integers(-128, 128, (n, 48), dtype=np.int8)
                             ).to(device)
    rgba = torch.from_numpy(rng.integers(0, 256, (n, 4), dtype=np.uint8)
                            ).to(device)
    # 3-byte rows starting 3 bytes into their storage: the staged copies
    # take their byte path.
    odd = torch.from_numpy(rng.integers(0, 256, (n + 1, 3), dtype=np.uint8)
                           ).to(device)[1:]

    def one(name, kernel, widths, groups, block, config=None, entry=None):
        bld = KernelBundleBuilder().label(name)
        for k, g in enumerate(groups):
            bld.resource_layout(ResourceGroupLayout(f"group {k}", len(g)))
        if entry is None:
            bld.kernel(kernel)
        else:
            bld.kernel_module(kernel).entry_point(entry)
        for w in widths:
            bld.output(w)
        if config is not None:
            bld.layout_config(config)
        return bld.block_size(block)

    update = _map_add_builder().block_size(1024).build([[c, c]])
    update.update_resources([[a, c]])
    few = BUNDLE_FEW
    cases = [
        ("map_add", _map_add_builder().block_size(256).build([[a, b]]),
         [[a, b]]),
        ("constants", _map_add_builder().constants(scale=10.0)
         .block_size(64).build([[a, b]]), [[a, b]]),
        ("caller-managed", _map_add_builder().block_size(128)
         .build_without_resources(), [[b, c]]),
        ("update_resources", update, [[a, c]]),
        ("groups and outputs", one("sum prod", SUM_PROD, (1, 1),
                                   [[a, b], [c]], 64).build([[a, b], [c]]),
         [[a, b], [c]]),
        ("[N, 8] rows", one("times2", _times_cuda(2, 8), (8,), [[x8]], 32)
         .build([[x8]]), [[x8]]),
        ("entry points", one("module", {"double": _times_cuda(2, 1),
                                        "triple": _times_cuda(3, 1)},
                             (1,), [[a]], 16, entry="triple").build([[a]]),
         [[a]]),
        ("config-specialised", one("cov3d", COV3D, (6,), [[cov7]], 8,
                                   config=True).build([[cov7]]), [[cov7]]),
        ("casts", one("casts", CASTS, (6, 45, 4), [[half, norm8, rgba]],
                      256).build([[half, norm8, rgba]]),
         [[half, norm8, rgba]]),
        ("unaligned rows", one("widen", WIDEN, (3,), [[odd]], 64)
         .build([[odd]]), [[odd]]),
    ]
    return [(name, bundle, res, n) for name, bundle, res in cases] + [
        ("below one tile", _map_add_builder().build_without_resources(),
         [[a[:few], b[:few]]], few)]


def bundle_sources(cases):
    """Every bundle source of phases 10-11, to build in phase 1."""
    return ([b.cuda_source(n, res) for _, b, res, n in cases]
            + [ub.unpack_source(layout, MODEL) for layout in ALL_LAYOUTS])


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def equal_bits(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def abs_err(a, b) -> float:
    """max |a - b| over two tensors of one shape, in f64 (0 when empty)."""
    d = (a.double() - b.to(a.device).double()).abs()
    return float(d.max()) if d.numel() else 0.0


def phase_bundles(cases):
    """Each bundle on the card against the plain launcher on CPU copies of
    the same inputs, bit for bit. Returns the largest abs difference over
    every output (0 when all are equal)."""
    err = 0.0
    for name, bundle, res, n in cases:
        own = bundle._resources is None  # caller-managed resources
        got = as_tuple(bundle.dispatch(n, res if own else None))
        cpu_res = [[t.cpu() for t in g] for g in res]
        want = as_tuple(bundle.dispatch(n, cpu_res))
        if not all(g.shape == w.shape for g, w in zip(got, want)):
            fail(f"K8 bundle {name!r}: output shapes differ")
        err = max([err] + [abs_err(g.cpu(), w) for g, w in zip(got, want)])
        if not all(equal_bits(g.cpu(), w) for g, w in zip(got, want)):
            fail(f"K8 bundle {name!r} differs from the plain launcher")
        if name == "caller-managed":
            try:
                bundle.dispatch(n)
            except KernelBundleResourceCountError:
                pass
            else:
                fail("a bundle without resources dispatched")
    print(f"phase 10 K8 kernel bundles vs the plain launcher "
          f"({BUNDLE_N} items; {BUNDLE_FEW} below one tile): "
          + ", ".join(name for name, *_ in cases)
          + f" bit-identical (max abs err {err}); items a tile "
          + ", ".join(f"{name} {plan_of(bundle, res, n)}"
                      for name, bundle, res, n in cases), flush=True)
    return err


def plan_of(bundle, res, n) -> str:
    """The tile a dispatch of ``bundle`` gets on the card: its items and
    the shared bytes of its block."""
    rows = [t.shape[1] * t.element_size() if t.dim() == 2
            else t.element_size() for g in res for t in g]
    rows += [o.width * o.dtype.itemsize for o in bundle._outputs]
    items = tile_plan(rows, bundle.block_size)
    return f"{items} ({tile_smem(rows, items)} B)" if items else "direct"


def check_unpack(outs, buf, layout):
    """A bundle unpack against the plain one: world, rgba and sh bit for
    bit, sigma6 bit for bit for SINGLE/HALF and within SIGMA_TOL of the
    row's largest |sigma| for ROT_SCALE. Returns (max abs err over the
    four outputs, sigma's normalized err)."""
    d = buf.data
    want = ub.unpack_plain(d.pos, d.color, d.sh, d.cov3d, layout, MODEL)
    err = max(abs_err(a, b) for a, b in zip(outs, want))
    for name, a, b in zip(("world", "rgba", "sh"), outs[:3], want[:3]):
        if not equal_bits(a, b):
            fail(f"K8 unpack {layout}: {name} differs from the plain unpack")
    sig, sig_want = outs[3], want[3]
    if layout.cov3d != Cov3dFormat.ROT_SCALE:
        if not equal_bits(sig, sig_want):
            fail(f"K8 unpack {layout}: sigma6 cast differs")
        return err, 0.0
    if not torch.isfinite(sig).all():
        fail(f"K8 unpack {layout}: sigma6 is not finite")
    norm = normalized_err(sig, sig_want)
    if not norm <= SIGMA_TOL:
        fail(f"K8 unpack {layout}: sigma6 differs by {norm} normalized")
    return err, norm


def packed_bytes_equal(a, b) -> bool:
    return all(
        (x is None and y is None) or (x is not None and y is not None
                                      and x.dtype == y.dtype
                                      and x.tobytes() == y.tobytes())
        for x, y in ((a.pos, b.pos), (a.color, b.color), (a.sh, b.sh),
                     (a.cov3d, b.cov3d)))


def in_turns(calls, rounds=3) -> dict:
    """Each callable's device time (device_ms), in turns: the median over
    ``rounds`` rounds of one device_ms each, in ms."""
    turns: dict[str, list] = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            turns[name].append(device_ms(fn))
    return {name: statistics.median(v) for name, v in turns.items()}


def phase_core(device, soa):
    """The core layer's compute path at full width in all 12 layouts (the
    path whose launches phase 11 reports), then its timing."""
    n = len(soa)
    start, q = n // 2, n // 4
    fresh = to_soa(*draw_scene(q, 11, **BENCH_SCENE))
    updated = GaussianSoA.concatenate([soa[:start], fresh,
                                       soa[start + q:]])
    errs, norms, reversible = [], [], 0
    default = None
    torch.cuda.synchronize(device)
    reset_launch_counts()
    for layout in ALL_LAYOUTS:
        packed = pack(soa, layout)
        buf = GaussiansBuffer.new_with_packed(packed, device)
        bundle = ub.unpack_bundle(buf, MODEL)
        out = bundle.dispatch(n)
        e1, n1 = check_unpack(out, buf, layout)
        buf.update_range(start, fresh)  # in place: the bundle sees it
        out = bundle.dispatch(n)
        e2, n2 = check_unpack(out, buf, layout)
        errs += [e1, e2]
        norms += [n1, n2]
        want = pack(fresh, layout)
        for name in ("pos", "color", "sh", "cov3d"):
            field = getattr(packed, name)
            if field is not None:
                field[start:start + q] = getattr(want, name)
        if not packed_bytes_equal(buf.download_packed(), packed):
            fail(f"download_packed of {layout} differs from the host pack")
        if (layout.sh != ShFormat.NONE
                and layout.cov3d == Cov3dFormat.ROT_SCALE):
            got, host = buf.download_gaussians(), unpack(packed)
            if not all(getattr(got, f).tobytes() == getattr(host, f).tobytes()
                       for f in ("rot", "pos", "color", "sh", "scale")):
                fail(f"download_gaussians of {layout} differs")
            if not all(getattr(got, f).tobytes() == getattr(updated, f)
                       .tobytes() for f in ("rot", "pos", "color", "scale")):
                fail(f"download_gaussians of {layout} lost the gaussians")
            reversible += 1
        else:
            try:
                buf.download_gaussians()
            except IrreversibleConfigError:
                pass
            else:
                fail(f"download_gaussians of {layout} did not raise")
        if layout == GaussianLayout():
            default = (buf, bundle)
        del buf, bundle
    torch.cuda.synchronize(device)
    launches = launch_counts()["kernel_bundle"]
    if launches < 1:
        fail("no kernel bundle ran on the core path")

    buf, bundle = default
    d = buf.data
    plain_ms = cuda_ms(lambda: ub.unpack_plain(d.pos, d.color, d.sh, d.cov3d,
                                               buf.layout, MODEL), reps=REPS)
    in_bytes = sum(t.numel() * t.element_size() for t in ub.resources(buf))
    out_bytes = 4 * sum(ub.OUTPUT_WIDTHS) * n
    unpack_bound = bound(in_bytes + out_bytes, 0)

    gen = torch.Generator(device=device).manual_seed(11)
    a, b = (torch.rand(MAP_ADD_N, generator=gen, device=device)
            for _ in range(2))
    add = _map_add_builder().build([[a, b]])
    free = _map_add_builder().build_without_resources()
    want = torch.add(a, b)
    for design, out in (("", add.dispatch(MAP_ADD_N)),
                        (" (caller-managed)", free.dispatch(MAP_ADD_N,
                                                            [[a, b]]))):
        if not equal_bits(out[:, 0], want):
            fail(f"K8{design} map_add differs from torch.add")
    calls = {
        "unpack": lambda: bundle.dispatch(n),
        "map_add": lambda: add.dispatch(MAP_ADD_N),
        "torch.add": lambda: torch.add(a, b),
    }
    t = in_turns(calls)
    call = {name: cuda_ms(fn) for name, fn in calls.items()}
    host_ms = {
        "unpack": enqueue_ms(lambda: bundle.dispatch(n), REPS),
        "map_add": enqueue_ms(lambda: add.dispatch(MAP_ADD_N), REPS),
        "map_add caller-managed": enqueue_ms(
            lambda: free.dispatch(MAP_ADD_N, [[a, b]]), REPS),
        "torch.add": enqueue_ms(lambda: torch.add(a, b), REPS),
    }
    add_bound = bound(3 * 4 * MAP_ADD_N, 0)
    print(f"phase 11 K8 in turns (median of 3 medians of 10 calls' device "
          f"time, profiler), ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f"; unpack / bound ({unpack_bound[0]:.4f} ms) "
          f"{t['unpack'] / unpack_bound[0]:.3f}; map_add / torch.add "
          f"{t['map_add'] / t['torch.add']:.3f}, / bound "
          f"({add_bound[0]:.4f} ms) {t['map_add'] / add_bound[0]:.3f}; one "
          f"call by CUDA events, ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in call.items())
          + "; host enqueue per call, ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in host_ms.items())
          + f" (map_add / torch.add "
          f"{host_ms['map_add'] / host_ms['torch.add']:.2f}); items a tile "
          f"(shared bytes a block): unpack "
          f"{plan_of(bundle, [ub.resources(buf)], n)}, map_add "
          f"{plan_of(add, [[a, b]], MAP_ADD_N)}", flush=True)
    print(f"phase 11 core path ({n} gaussians, 12 layouts, model transform "
          f"{MODEL}): upload, bundle unpack, update_range of {q} at {start} "
          f"(in place) and unpack again: world/rgba/sh and sigma casts "
          f"bit-identical, max abs err over every output {max(errs):.3g}, "
          f"ROT_SCALE sigma normalized {max(norms):.3g} (tol {SIGMA_TOL}); "
          f"download_packed "
          f"bit-identical to the host pack in 12 layouts; download_gaussians "
          f"round-trips {reversible}, raises IrreversibleConfigError on "
          f"{12 - reversible}; {launches} bundle launches; SINGLE/ROT_SCALE unpack "
          f"device {t['unpack']:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{unpack_bound[0]:.4f} ms ({in_bytes + out_bytes} B); map_add over "
          f"{MAP_ADD_N} f32 device {t['map_add']:.4f} ms, torch.add "
          f"{t['torch.add']:.4f} ms, bound {add_bound[0]:.4f} ms",
          flush=True)
    return (launches, max(errs),
            (t["unpack"], plain_ms, None, call["unpack"]), unpack_bound)


def k7_inputs(spl, tiles_x, tiles_y, cap):
    """K7's arguments as bin_splats hands them."""
    table, total = bbox_table(spl.xy, spl.extent, spl.mask, tiles_x, tiles_y)
    return table, total, cap, tiles_x, tiles_x * tiles_y


def phase_binning(device, mid, scene):
    """One-level bin_splats of the mid and bench scenes' projections (the
    path whose K7 launches phase 12 reports), then K7 against its plain
    version and the stream against the CPU's."""
    runs = []
    for name, cam, args in (("mid", mid[0], mid[1]),
                            ("bench", scene[2], scene[3])):
        means, cov6, _, opac, _ = args
        spl = project(means, cov6, cam, opacity=opac)
        tx, ty = num_tiles(cam.width, cam.height)
        count = int(count_fragments(spl.xy, spl.extent, spl.mask, tx, ty))
        cap = -(-(3 * count) // 1024) * 512  # count x 1.5, up to 512
        runs.append((name, spl, tx, ty, cap))
    torch.cuda.synchronize(device)
    reset_launch_counts()
    streams = [bin_splats(spl.xy, spl.extent, spl.depth, spl.mask, tx, ty,
                          cap) for _, spl, tx, ty, cap in runs]
    torch.cuda.synchronize(device)
    launches = launch_counts()["expand_fragments_bbox"]
    if launches < 1:
        fail("K7 did not run on the one-level binning")
    notes, err = [], 0.0
    for (name, spl, tx, ty, cap), stream in zip(runs, streams):
        if bool(stream.overflow):
            fail(f"bin_splats of the {name} scene overflowed")
        cpu = bin_splats(*(t.cpu() for t in (spl.xy, spl.extent, spl.depth,
                                            spl.mask)), tx, ty, cap)
        for field, a, b in zip(stream._fields, stream, cpu):
            if not torch.equal(a.cpu(), b):
                fail(f"bin_splats of the {name} scene: {field} differs "
                     "from the CPU's")
        k7 = k7_inputs(spl, tx, ty, cap)
        err = max(err, check_k7(f"the {name} scene", k7))
        notes.append(f"{name} {spl.xy.shape[0]} gaussians, "
                     f"{int(stream.num_fragments)} fragments, capacity {cap}")
    for name, args in expand_tables.hard_tables(device).items():
        err = max(err, check_k7(f"the hard table {name}", args))
    # K7's bound: the bytes it must move. It reads 5 of the table's 6
    # columns (off, span, x0, y0, gid; not the count) of the live rows
    # only (the count-0 tail rows own no slot), and writes tile and gid
    # of every slot.
    table, cap = k7[0], k7[2]
    live = int((table.ints[ex.TAB_CNT] > 0).sum())
    k7_bytes = 4 * (ex.TAB_ROWS - 1) * live + 8 * cap
    k7_bound = bound(k7_bytes, 0)
    t = in_turns({"K7": lambda: ex.expand_fragments(*k7)})
    ms = (t["K7"], cuda_ms(lambda: ex.expand_fragments_plain(*k7), reps=REPS),
          None, cuda_ms(lambda: ex.expand_fragments(*k7)))
    blocks = -(-(table.ints.shape[1] + cap) // ex.MERGE_ITEMS)
    print(f"phase 12 one-level bin_splats (K7): " + "; ".join(notes)
          + f"; no overflow, every stream field equal to the CPU's, K7 "
          f"bit-identical to plain there and on the hard tables "
          f"{', '.join(expand_tables.HARD_TABLES)} (max abs err {err}); "
          f"{launches} K7 launches; bench K7 (median of 3 medians of 10 "
          f"calls' device time): {t['K7']:.4f} ms, K7 / bound {t['K7'] / k7_bound[0]:.2f}; one call {ms[3]:.4f} ms; "
          f"plain {ms[1]:.3f} ms; {blocks} blocks of {ex.MERGE_ITEMS} merge "
          f"steps; bound {k7_bound[0]:.4f} ms ({k7_bytes} B: 20 B x {live} "
          f"live table rows + 8 B x {cap} slots; 24 B x all "
          f"{table.ints.shape[1]} rows would give "
          f"{bound(4 * ex.TAB_ROWS * table.ints.shape[1] + 8 * cap, 0)[0]:.4f}"
          f" ms)", flush=True)
    return launches, err, ms, k7_bound


def check_k7(name, k7) -> float:
    """K7 bit for bit its plain version on ``k7`` (K7's arguments);
    returns the max abs difference from plain (0)."""
    got, want = ex.expand_fragments(*k7), ex.expand_fragments_plain(*k7)
    for a, w in zip(got, want):
        if not torch.equal(a, w):
            fail(f"K7 differs from its plain version on {name}")
    return max(abs_err(g, w) for g, w in zip(got, want))


# ------------------------------- phases 13-18: the measurement path


def tile_err(got, want) -> float:
    """max over tiles of max |got - want| / max |want| over the tile's
    [4, 256] (tiles of zeros compare absolutely)."""
    err = (got - want).abs().amax(dim=(1, 2))
    scale = want.abs().amax(dim=(1, 2))
    return float(torch.where(scale > 0, err / scale, err).max())


def phase_probe(device):
    """K11 through the probe tool (every form checked at the TPU probe's
    and the rasterizer's shapes, and timed at the latter: the path whose
    launches the kernels line reports), then its plain version timed."""
    torch.cuda.synchronize(device)
    reset_launch_counts()
    result = k11.run(device)
    torch.cuda.synchronize(device)
    launches = launch_counts()["probe_dyngrid"]
    if launches < 1:
        fail("K11 did not run on the probe's path")
    cap, block_elems, lives = k11.RASTER_CASE
    live = lives[-1]
    x = torch.rand(cap * block_elems, device=device)
    count = torch.tensor([live], dtype=torch.int32, device=device)
    out = torch.full_like(x, k11.SENTINEL)
    plain_ms = cuda_ms(lambda: pr.probe_plain(x, out, count, block_elems),
                       reps=REPS)
    ms = result["ms"]
    dev_ms = device_ms(lambda: pr.probe("capacity", x, out, count,
                                        block_elems))
    call_ms = cuda_ms(lambda: pr.probe("capacity", x, out, count,
                                       block_elems))
    probe_bound = bound(8 * live * block_elems, 0)
    print(f"phase 13 K11 live-bound launch (x + 1 over blocks, the count in "
          f"a device int32): forms {', '.join(pr.FORMS)} equal to the plain "
          f"version (prefix x + 1, tail untouched) at live blocks "
          f"{', '.join(result['checked'])}; {launches} launches; ms at "
          f"{cap} blocks of {block_elems} f32: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + "; device kernel ms (profiler) "
          + ", ".join(f"{k} {v:.4f}" for k, v in result["device_ms"].items()
                      if v is not None)
          + f"; capacity form at {live} live: device {dev_ms:.4f} ms "
          f"(median of 10 calls), one call {call_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; bound {probe_bound[0]:.4f} ms (8 B per live "
          f"element)", flush=True)
    # The kernels line holds the capacity form's device time at full live.
    return (launches, result["max_abs_err"],
            (dev_ms, plain_ms, None, call_ms), probe_bound)


def level_table(levels: dict) -> str:
    """A tool's level table: each level's device ms and its step from the
    level before."""
    return ", ".join(
        f"{k} {v['ms']:.4f} ms"
        + ("" if v["step_ms"] is None else f" ({v['step_ms']:+.4f})")
        for k, v in levels.items())


def check_prep(name, operand, gid_col, n, got, scratch):
    """s0_prep against its plain version, bit for bit: the zeroed output,
    the staging copy operand.T and each live gid's first row in row_of
    (the other entries as they were, compared with a plain prep over a
    copy of them)."""
    grad_t, row_of = scratch
    if got.any():
        fail(f"K10 s0_prep on the {name} stream left a nonzero output")
    if not equal_bits(grad_t, operand.T.contiguous()):
        fail(f"K10 s0_prep's staging copy on the {name} stream is not "
             f"grad.T")
    want = row_of.clone()
    va.prep_plain(operand, gid_col, n, None, want)
    if not torch.equal(row_of, want):
        fail(f"K10 s0_prep's row map on the {name} stream differs from its "
             f"plain version")


def k10_full_levels(name, st, k5):
    """s1_scan, s2_gather and s2_nostage on the stream ``st`` bit for bit
    K5's output ``k5``."""
    keys, perm, grad, gid_col, n = st
    for level in ("s1_scan", "s2_gather", "s2_nostage"):
        got = va.segment_sums_level(level, keys, perm,
                                    va.level_operand(level, grad, perm),
                                    gid_col, n)
        if not equal_bits(got, k5):
            fail(f"K10 {level} on the {name} stream differs from K5")


def phase_segsum_variants(device, bi, bound5):
    """K10's levels through the tool on the TPU tool's synthetic stream and
    on the bench step's backward stream (phase 8's), in device ms with the
    step from the level before. Every level is held to its plain version
    (s0_prep bit for bit, the others within K5_TOL of the row's largest
    sum) and s1_scan, s2_gather (K5 compiled again) and s2_nostage to K5
    bit for bit, there and on the seven hard streams. Then K5, s2_gather
    and segment_reduce in turns on the bench-step stream (device ms)."""
    streams = (("synthetic", k10.synthetic_stream(*SEGSUM_SYNTHETIC,
                                                  device=device)),
               ("bench step", bi["k5"]))
    torch.cuda.synchronize(device)
    reset_launch_counts()
    results = {name: k10.run(*st) for name, st in streams}
    torch.cuda.synchronize(device)
    launches = launch_counts()["segment_sum_variants"]
    if launches < 1:
        fail("K10 did not run on the variant bench's path")
    err = 0.0
    for name, st in streams:
        keys, perm, grad, gid_col, n = st
        k5 = sr.segment_sums_sorted(*st)
        for level in va.SEGSUM_LEVELS:
            operand = va.level_operand(level, grad, perm)
            scratch = (torch.empty((keys.shape[0], sr.GRAD_ROWS),
                                   device=device),
                       torch.empty(n, dtype=torch.int32, device=device))
            got = va.segment_sums_level(level, keys, perm, operand, gid_col,
                                        n, scratch=scratch)
            if level == "s0_prep":
                check_prep(name, operand, gid_col, n, got, scratch)
                continue
            want = va.segment_sums_level_plain(level, keys, perm, operand,
                                               gid_col, n)
            err = max(err, abs_err(got, want))
            norm = normalized_err(got, want)
            if not norm <= K5_TOL:
                fail(f"K10 {level} on the {name} stream differs from its "
                     f"plain version by {norm}")
        k10_full_levels(name, st, k5)
    for name, st in k10.hard_streams(device=device).items():
        k10_full_levels(name, st, sr.segment_sums_sorted(*st))
    plain_ms = cuda_ms(
        lambda: va.segment_sums_level_plain("s2_gather", *bi["k5"]))
    for name, res in results.items():
        print(f"phase 14 K10 segment-sum levels ({name} stream, "
              f"{res['f']} slots, {res['rows']} rows; device ms, step from "
              f"the level before): {level_table(res['levels'])}; "
              f"segment_reduce "
              f"{res['segment_reduce_ms']:.4f} ms", flush=True)
    print(f"phase 14 K10 checks: s0_prep's output, staging copy and row map "
          f"bit for bit its plain version; s1_scan, s2_gather, s2_nostage "
          f"within {K5_TOL} of their plain versions (max abs err "
          f"{err:.3g}) and bit for bit K5 on both streams and the "
          f"{len(k10.HARD_STREAMS)} hard streams; {launches} launches; "
          f"bench-step "
          f"s2_gather plain {plain_ms:.3f} ms", flush=True)
    k5, lib = bi["k5"], k10.segment_reduce_call(*bi["k5"])
    calls = {"K5": lambda: sr.segment_sums_sorted(*k5),
             "K10 s2_gather": lambda: va.segment_sums_level("s2_gather", *k5),
             "segment_reduce": lib}
    t = in_turns(calls)
    print(f"phase 14 bench-step stream, in turns (device ms, median of 3): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f"; K5 / s2_gather {t['K5'] / t['K10 s2_gather']:.4f}, K5 / "
          f"bound ({bound5:.4f} ms) {t['K5'] / bound5:.2f}, K5 / "
          f"segment_reduce "
          f"{t['K5'] / t['segment_reduce']:.2f}", flush=True)
    s2 = (device_ms(calls["K10 s2_gather"]), plain_ms,
          device_ms(calls["segment_reduce"]),
          cuda_ms(calls["K10 s2_gather"]))
    print(f"phase 14 bench-step stream: s2_gather device {s2[0]:.4f} ms, one "
          f"call {s2[3]:.4f} ms; segment_reduce device {s2[2]:.4f} ms",
          flush=True)
    return launches, err, s2


def phase_raster_variants(device, inp, mid):
    """K9's levels through the tool on phase 4's bench stream, in device
    ms with the step from the level before; the boxes v0_stage wrote
    against the plain mirror (each bound within one pixel, the count that
    differ printed); v6_full (K3 compiled again) held to K3 bit for bit
    and every other level to its plain version, culled by the card's
    boxes, within K9_TOL of each tile's largest value; then, in both
    modes on the mid stream and the hard tiles, v6_full bit for bit K3 and
    K3 within K3_TOL of its plain version."""
    k3_args = inp["k3"]
    frags, start, draw_len, _, cutoff_sq, mode = k3_args
    torch.cuda.synchronize(device)
    reset_launch_counts()
    result = k9.run(*k3_args[:4], cutoff_sq=cutoff_sq, mode=mode)
    torch.cuda.synchronize(device)
    launches = launch_counts()["rasterize_variants"]
    if launches < 1:
        fail("K9 did not run on the variant bench's path")
    k3 = ra.rasterize_tiles_fwd(*k3_args)
    boxes = torch.empty(frags.shape[1], dtype=torch.int32, device=device)
    va.rasterize_level("v0_stage", *k3_args, boxes=boxes)
    staged = va.staged_slots(start, draw_len)
    box_diff = (va.box_rows(boxes[staged])
                - ra.frag_pixel_box_plain(frags[:, staged], cutoff_sq, mode)
                ).abs()
    if int(box_diff.max()) > 1:
        fail(f"v0_stage's boxes differ from the plain mirror's by "
             f"{int(box_diff.max())} pixels")
    n_box_diff = int(box_diff.amax(dim=0).gt(0).sum())
    errs, norms = {}, {}
    for level in va.RASTER_LEVELS:
        got = va.rasterize_level(level, *k3_args)
        if not torch.isfinite(got).all():
            fail(f"K9 {level} output is not finite")
        want = va.rasterize_level_plain(level, *k3_args, cull_boxes=boxes)
        errs[level] = abs_err(got, want)
        norms[level] = tile_err(got, want)
        if level == "v6_full":
            if not equal_bits(got, k3):
                fail("K9 v6_full differs from K3")
        elif not norms[level] <= K9_TOL:
            fail(f"K9 {level} differs from its plain version by "
                 f"{norms[level]} of the tile's largest value")
    v5_k3 = equal_bits(va.rasterize_level("v5_color", *k3_args), k3)
    cases = [(f"mid/{mode}", with_mode(mid[3]["k3"], mode))
             for mode in (0, 1)] + hard_tile_cases(device)
    k3_plain = 0.0
    for name, args in cases:
        k3 = ra.rasterize_tiles_fwd(*args)
        if not equal_bits(va.rasterize_level("v6_full", *args), k3):
            fail(f"K9 v6_full on {name} differs from K3")
        err = abs_err(k3, ra.rasterize_tiles_fwd_plain(*args))
        if not err <= K3_TOL:
            fail(f"K3 on {name} differs from its plain version by {err}")
        k3_plain = max(k3_plain, err)
    plain_ms = cuda_ms(lambda: va.rasterize_level_plain("v6_full", *k3_args),
                       iters=3)
    v6 = (device_ms(lambda: va.rasterize_level("v6_full", *k3_args)),
          plain_ms, None,
          cuda_ms(lambda: va.rasterize_level("v6_full", *k3_args)))
    n_t = result["tiles"]
    print(f"phase 15 K9 rasterizer levels (bench stream, {n_t} tiles, "
          f"{result['fragments']} fragments; device ms, step from the level "
          f"before): {level_table(result['levels'])}", flush=True)
    print(f"phase 15 K9 checks: v0_stage's boxes within one pixel of the "
          f"plain mirror's ({n_box_diff} of {staged.numel()} differ); "
          f"v6_full bit-identical to K3 (also in both modes on the mid "
          f"stream and the {len(k9.HARD_TILES)} hard tile sets, where K3 is "
          f"within {k3_plain:.3g} of its plain version, tol {K3_TOL}), v5_color bit-identical to K3: {v5_k3}; "
          f"normalized err vs plain (culled by the card's boxes) "
          + ", ".join(f"{k} {v:.3g}" for k, v in norms.items())
          + f" (tol {K9_TOL}; v6 held to K3; max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"); {launches} launches; v6_full device {v6[0]:.4f} ms, one "
          f"call {v6[3]:.4f} ms, plain {plain_ms:.3f} ms", flush=True)
    # The kernels line holds the full level: its time, bound and error.
    return launches, errs["v6_full"], v6


def phase_port_bench(device):
    """The port bench in-process, its headline run and --full: each prints
    its JSON line; every overflow flag must be false."""
    args = ["--device", str(device), *PORT_BENCH_ARGS]
    lines = [port_bench.main(args), port_bench.main(["--full", *args])]
    for line in lines:
        if line["overflow"] or line.get("heavy_overflow", False):
            fail(f"the port bench overflowed its capacities: {line}")
        if not np.isfinite(line["loss"]) or line["step_ms"] <= 0:
            fail(f"the port bench's line is not a measurement: {line}")
    full = lines[1]
    print(f"phase 16 port bench: step {lines[0]['step_ms']} / "
          f"{full['step_ms']} ms (headline, --full), fwd {full['fwd_ms']} ms, "
          f"heavy step {full['heavy_step_ms']} ms, loss {full['loss']:.8g}, "
          f"no overflow", flush=True)


def phase_grad_parity(device):
    out = grad_parity.run(**GRAD_PARITY, device=device)
    print(json.dumps(out), flush=True)
    if not out["pass_1e-4"]:
        fail(f"bench-shape gradients differ from the reference's: {out}")
    print(f"phase 17 bench-shape gradient parity ({out['n']} gaussians, "
          f"{out['resolution']}, {out['crop']}x{out['crop']} crop): worst "
          f"normalized err {out['worst_normalized_err']:.3g} (bar "
          f"{grad_parity.BAR})", flush=True)


def phase_ellipse(scene):
    """ELLIPSE capacities: measured for the mode's binning (its whole flat
    ring, no opacity cull) at headroom 1.0, the bench scene renders
    without overflow."""
    _, _, cam, (means, cov6, color, opac, sh), _ = scene
    splat = measure_capacities(means, cov6, opac, cam, headroom=1.0)
    caps = measure_capacities(means, cov6, opac, cam, headroom=1.0,
                              display_mode=GaussianDisplayMode.ELLIPSE)
    res = render(means, cov6, color, opac, cam, sh=sh, sh_deg=3,
                 display_mode=GaussianDisplayMode.ELLIPSE,
                 max_fragments=caps[0], max_rows=caps[1])
    if bool(res.overflow):
        fail(f"the ELLIPSE render overflowed its measured capacities {caps}")
    if not torch.isfinite(res.image).all():
        fail("the ELLIPSE image is not finite")
    print(f"phase 18 ELLIPSE capacities (bench scene, headroom 1.0): "
          f"{caps[0]} fragments / {caps[1]} rows (SPLAT's {splat[0]} / "
          f"{splat[1]}); render without overflow", flush=True)


def longest_tile(k4):
    """K4's arguments for the tile with the most drawn fragments alone (its
    slots cut out of the stream, so no padding is zeroed), and its
    index."""
    frags, start, tile_len, draw_len, out, g_out, bg, cutoff_sq, mode = k4
    t = int(torch.argmax(draw_len))
    s0, n = int(start[t]), int(tile_len[t])
    one = slice(t, t + 1)
    return (frags[:, s0:s0 + n].contiguous(), torch.zeros_like(start[one]),
            tile_len[one], draw_len[one], out[one].contiguous(),
            g_out[one].contiguous(), bg, cutoff_sq, mode), t


def phase_raster_redesign(device, inp, bi, counts, bounds):
    """K3 against K9's v6_full (K3 compiled again) and K4, in turns on the
    bench stream (device ms, median of 3, as in phase 14), with K4 on its
    longest tile alone against the whole kernel in the same turns; and the
    cull's counts on the bench stream."""
    k3, k4 = inp["k3"], bi["k4"]
    tile_args, tile = longest_tile(k4)
    calls = {
        "K3": lambda: ra.rasterize_tiles_fwd(*k3),
        "K9 v6_full": lambda: va.rasterize_level("v6_full", *k3),
        "K4": lambda: ra.rasterize_tiles_bwd(*k4),
        "K4 longest tile": lambda: ra.rasterize_tiles_bwd(*tile_args),
    }
    torch.cuda.synchronize(device)
    t = in_turns(calls)
    kept, skipped = k9.cull_counts(*k3[:3])
    b3, b4 = bounds["rasterize_fwd"][0], bounds["rasterize_bwd"][0]
    print(f"phase 19 rasterizer redesign, in turns on the bench stream "
          f"(device ms, median of 3): "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f"; K3 / v6_full {t['K3'] / t['K9 v6_full']:.4f}, K3 / bound "
          f"({b3:.4f} ms) {t['K3'] / b3:.2f}; K4 / bound ({b4:.4f} ms) {t['K4'] / b4:.2f}", flush=True)
    print(f"phase 19 cull on the bench stream ({counts['drawn']} drawn "
          f"fragments, {8 * counts['drawn']} (warp, fragment) pairs): kept "
          f"{kept}, skipped {skipped}, blending warp events "
          f"{counts['warp_events']}; tail: the longest tile ({tile}, "
          f"{int(k4[3][tile])} drawn fragments) alone "
          f"{t['K4 longest tile']:.4f} ms = "
          f"{t['K4 longest tile'] / t['K4']:.3f} of the whole K4",
          flush=True)


# ------------------------------------------- phases 20-21: the sharded path


def sharded_kwargs(kw):
    """render_sharded's (and the plain render compared with it) keyword
    arguments of a scene: its fragment capacity and pad_slack. No
    max_rows: both then size the row stream by the fragment capacity, as
    the JAX sharded path does."""
    return dict(sh_deg=3, background=kw["background"],
                max_fragments=kw["max_fragments"], pad_slack=kw["pad_slack"])


def phase_sharded_one(device, scene):
    """D=1 in this process (NCCL on the card): render_sharded against
    render on the bench scene, image bit for bit and gradients; the path's
    K1-K6 launches; the two steps in turns."""
    _, _, cam, args, kw = scene
    kw = sharded_kwargs(kw)
    backend = "nccl" if device.type == "cuda" else "gloo"
    initialize_multihost(f"localhost:{free_port()}", 1, 0, backend=backend,
                         local_device_ids=None if device.type == "cpu"
                         else [device.index])
    try:
        mesh = make_mesh()
        x = leaves(args)

        def step(sharded):
            res = (render_sharded(*x[:4], cam, mesh, sh=x[4], **kw)
                   if sharded else render(*x[:4], cam, sh=x[4], **kw))
            loss = torch.mean(res.image ** 2)
            return res, torch.autograd.grad(loss, x)

        torch.cuda.synchronize(device)
        reset_launch_counts()
        res, grads = step(True)
        torch.cuda.synchronize(device)
        launches = {k: v for k, v in launch_counts().items()
                    if k in RENDER_KERNELS}
        if min(launches.values()) < 1:
            fail(f"a kernel of the sharded step did not run: {launches}")
        plain, want = step(False)
        if bool(res.overflow) or bool(plain.overflow):
            fail("the D=1 sharded render overflowed")
        if not (torch.equal(bits(res.image), bits(plain.image))
                and torch.equal(bits(res.transmittance),
                                bits(plain.transmittance))):
            fail("the D=1 sharded image differs from render's")
        errs = {name: normalized_err(a.reshape(1, -1), b.reshape(1, -1))
                for name, a, b in zip(GRAD_NAMES, grads, want)}
        if not max(errs.values()) <= GRAD_TOL:
            fail(f"D=1 sharded gradients differ from render's: {errs}")
        same = all(torch.equal(a, b) for a, b in zip(grads, want))
        times = {True: [], False: []}
        for _ in range(STEP_PAIRS):
            for sharded in (True, False):
                times[sharded].append(cuda_ms(lambda: step(sharded),
                                              warmup=0, iters=1))
        kinds = {s: ms_by_kind(lambda: step(s))[0] for s in (True, False)}
    finally:
        torch.distributed.destroy_process_group()
    med = {s: statistics.median(times[s]) for s in (True, False)}
    dev = {s: sum(kinds[s].values()) for s in (True, False)}
    print(f"phase 20 sharded D=1 ({backend}, one rank, bench scene, "
          f"{FULL['n']} gaussians, {FULL['width']}x{FULL['height']}, "
          f"max_fragments {kw['max_fragments']}, pad_slack "
          f"{kw['pad_slack']}): image bit for bit render's, overflow "
          f"False, gradients "
          + ("bit for bit" if same else "normalized err " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items()))
          + f" (tol {GRAD_TOL}), launches {launches}; training step in "
          f"turns ({STEP_PAIRS} pairs, CUDA events) median sharded "
          f"{med[True]:.3f} ms, render {med[False]:.3f} ms "
          f"({med[True] / med[False]:.3f}x); device ms (profiler, mean of "
          f"{PROFILE_FWD}) sharded {dev[True]:.3f}, render "
          f"{dev[False]:.3f}, the sharded step's beyond render's by kind: "
          + ", ".join(
              f"{k} {extra:+.3f}" for extra, k in sorted(
                  ((kinds[True].get(k, 0.0) - kinds[False].get(k, 0.0), k)
                   for k in set(kinds[True]) | set(kinds[False])),
                  reverse=True)[:5]), flush=True)
    return dict(image=plain.image, grads=want)


def check_sharded(name, out, image, grads, expect_kernels):
    """The ranks of one spawn against render's image and gradients: every
    rank's image equal, within SHARDED_TOL of render's, the shards'
    gradients within GRAD_TOL, no overflow, every kernel of the path on
    every rank. Returns (max image err, gradient errs, launches a rank,
    strip stats)."""
    img = out[0]["image"]
    for r, it in enumerate(out):
        if it["overflow"]:
            fail(f"{name}: rank {r} overflowed ({it['stats']})")
        if not torch.equal(bits(it["image"]), bits(img)):
            fail(f"{name}: rank {r}'s replicated image differs from rank 0's")
    err = float((img - image.detach().cpu()).abs().max())
    if not err <= SHARDED_TOL:
        fail(f"{name}: image differs from render's by {err}")
    errs = {}
    for k, gname in enumerate(GRAD_NAMES):
        got = torch.cat([it["grads"][k] for it in out])
        errs[gname] = normalized_err(got.reshape(1, -1),
                                     grads[k].cpu().reshape(1, -1))
    if not max(errs.values()) <= GRAD_TOL:
        fail(f"{name}: gradients differ from render's: {errs}")
    launches = [{k: v for k, v in it["launches"].items()
                 if k in RENDER_KERNELS} for it in out]
    if expect_kernels and min(min(ln.values()) for ln in launches) < 1:
        fail(f"{name}: a kernel of the path did not run: {launches}")
    return err, errs, launches, [it["stats"] for it in out]


def phase_sharded_ranks(device, scene, one, mid):
    """D=2 and D=4 ranks on this card, spawned by parallel/launch.py under
    gloo (NCCL takes no two ranks on one card): the bench scene at D=2
    with the all_to_all exchange, the mid scene at D=4 with both, each
    against render; then dryrun_multichip(2)."""
    _, _, cam, args, kw = scene
    kw = sharded_kwargs(kw)
    on_card = device.type == "cuda"
    where = "cuda" if on_card else "cpu"
    arrays = [a.detach().cpu().numpy() for a in args]
    t0 = time.perf_counter()
    out = [o[0] for o in spawn_ranks(
        render_step, 2, (arrays, cam, [kw], None, True, STEP_PAIRS),
        backend="gloo", device=where, timeout=RANKS_TIMEOUT)]
    t_bench = time.perf_counter() - t0
    err, errs, launches, stats = check_sharded(
        "D=2 bench", out, one["image"], one["grads"], on_card)
    if not all(it["identical"] for it in out):
        fail("D=2: two backward passes gave different gradients")
    frags = [s["fragments"] for s in stats]
    print(f"phase 21 sharded D=2 (gloo, {len(out)} ranks on one card, "
          f"all_to_all, bench scene): image max abs err {err:.3g} (tol "
          f"{SHARDED_TOL}), gradients normalized err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {GRAD_TOL}), overflow False, two backward passes "
          f"bit-identical; launches by rank {launches}; strips: routed "
          f"{[s['routed'] for s in stats]} of route_cap "
          f"{stats[0]['route_cap']} a source, fragments {frags} of f_cap "
          f"{stats[0]['f_cap']} (max/mean "
          f"{max(frags) / statistics.mean(frags):.4f}), tile rows "
          f"{[s['rows'] for s in stats]}; spawn {t_bench:.1f} s (the "
          f"ranks' own work {max(it['seconds'] for it in out):.1f} s)",
          flush=True)
    print("phase 21 times, gloo staging through the host, one card: not a "
          "multi-GPU number: training step median by rank "
          + ", ".join(f"{statistics.median(it['step_ms']):.1f}"
                      for it in out)
          + f" ms ({STEP_PAIRS} steps); render's D=1 step in phase 20",
          flush=True)

    mcam, margs, (mf, _), _ = mid
    marrays = [a.detach().cpu().numpy() for a in margs]
    cases = [dict(sh_deg=3, background=BG, max_fragments=mf, exchange=ex)
             for ex in ("all_to_all", "all_gather")]
    x = leaves(margs)
    res = render(*x[:4], mcam, sh=x[4], sh_deg=3, background=BG,
                 max_fragments=mf)
    want = torch.autograd.grad(torch.mean(res.image ** 2), x)
    t0 = time.perf_counter()
    ranks = spawn_ranks(render_step, 4, (marrays, mcam, cases),
                        backend="gloo", device=where, timeout=RANKS_TIMEOUT)
    notes = []
    for k, case in enumerate(cases):
        err, errs, launches, stats = check_sharded(
            f"D=4 mid {case['exchange']}", [o[k] for o in ranks], res.image,
            want, on_card)
        frags = [s["fragments"] for s in stats]
        notes.append(
            f"{case['exchange']}: image err {err:.3g}, gradients worst "
            f"{max(errs.values()):.3g}, routed "
            f"{[s['routed'] for s in stats]}, fragments {frags} (max/mean "
            f"{max(frags) / statistics.mean(frags):.4f}), launches rank 0 "
            f"{launches[0]}")
    t_mid = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss = dryrun_multichip(2, device=where, backend="gloo")
    print(f"phase 21 sharded D=4 (gloo, one card, mid scene {MID['n']} "
          f"gaussians, {MID['width']}x{MID['height']}, tol {SHARDED_TOL} / "
          f"{GRAD_TOL}): " + "; ".join(notes) + f"; spawn {t_mid:.1f} s "
          f"(the ranks' own work {max(o[-1]['seconds'] for o in ranks):.1f}"
          f" s); "
          f"dryrun_multichip(2, gloo) loss {loss:.6g} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def numpy_codecs():
    """The SPZ codecs' numpy path: models/spz.py asks utils/native for the
    library on every call, so it takes the numpy path while this holds."""
    get_lib = native.get_lib
    native.get_lib = lambda: None
    try:
        yield
    finally:
        native.get_lib = get_lib


def host_ms(fn):
    """(fn's result, its host time in ms)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def scale_ties(native_q, numpy_q, scale) -> int:
    """The encoded scales where the native and numpy codecs differ: each
    one step apart and on a rounding tie (see TIE_TOL). Returns their
    count."""
    diff = native_q != numpy_q
    steps = np.abs(native_q[diff].astype(np.int32) - numpy_q[diff])
    code = (np.log(scale[diff].astype(np.float64)) + 10.0) * 16.0
    off_tie = np.abs(code - np.floor(code) - 0.5)
    if diff.any() and not (steps.max() == 1 and off_tie.max() <= TIE_TOL):
        fail(f"SPZ encode: native and numpy scales differ off a rounding "
             f"tie (steps {steps.max()}, {off_tie.max():.3g} from a half)")
    return int(diff.sum())


def spz_round_trip(soa, path):
    """The SPZ round trip at full width on the current codec path:
    Gaussians.from_soa(.., SPZ), write_to_file, read_from_file, to_soa.
    Returns (the SpzGaussians written, the one read back, the decoded
    GaussianSoA, host ms by step)."""
    written, enc = host_ms(lambda: Gaussians.from_soa(soa,
                                                      GaussiansSource.SPZ))
    _, wr = host_ms(lambda: written.write_to_file(path))
    read, rd = host_ms(lambda: Gaussians.read_from_file(path,
                                                        GaussiansSource.SPZ))
    decoded, dec = host_ms(read.to_soa)
    if read.data != written.data:
        fail("the SpzGaussians read back differ from those written")
    return written.data, read.data, decoded, dict(encode=enc, write=wr,
                                                  read=rd, decode=dec)


def check_spz_render(device, decoded, layout, cam, kw_base):
    """Upload the decoded scene in ``layout``, render it through K1-K3 at
    capacities measured on it, unpack it through K8, and hold each kernel
    against its plain version on that stream. Returns (the image, upload
    ms, render ms, launches, K3's max abs err, K8's max abs err)."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    buf = GaussiansBuffer.new(decoded, layout, device)
    torch.cuda.synchronize(device)
    up_ms = (time.perf_counter() - t0) * 1e3
    args = unpack_gaussians(buf.data)
    max_fragments, max_rows = measure_capacities(args[0], args[1], args[3],
                                                 cam)
    kw = dict(kw_base, max_fragments=max_fragments, max_rows=max_rows)
    transform = GaussianTransform(sh_deg=3)

    def forward():
        return render_gaussians(buf, cam, transform, **kw)

    torch.cuda.synchronize(device)
    reset_launch_counts()
    res = forward()
    bundle = ub.unpack_bundle(buf, MODEL)
    outs = bundle.dispatch(len(buf))
    torch.cuda.synchronize(device)
    launches = {k: v for k, v in launch_counts().items()
                if k in FORWARD_KERNELS + ("kernel_bundle",)}
    if any(v != 1 for v in launches.values()):
        fail(f"SPZ scene {layout}: K1-K3, K14 and K8 did not launch once "
             f"each: "
             f"{launches}")
    if bool(res.overflow):
        fail(f"SPZ scene {layout}: the render overflowed its capacities")
    if not (tuple(res.image.shape) == (cam.height, cam.width, 3)
            and torch.isfinite(res.image).all()):
        fail(f"SPZ scene {layout}: bad image")
    inp = kernel_inputs(args, cam, max_fragments, max_rows, kw["pad_slack"],
                        background=kw["background"])
    compare_expand(inp)
    lens = inp["k3"][2]
    densest = int(torch.argmax(lens))
    picks = np.random.default_rng(0).choice(lens.shape[0], 63, replace=False)
    e3 = compare_k3(inp, tiles=sorted(set(picks.tolist()) | {densest}))
    e8, _ = check_unpack(outs, buf, layout)
    return res.image, up_ms, cuda_ms(forward), launches, e3, e8


def phase_spz(device, scene, forward, card):
    """The SPZ slice: the bench scene through SPZ on the host (the native
    codec against the numpy one), rendered on the card through K1-K3 and
    unpacked through K8; then examples/model.spz against the reference
    renderer."""
    soa, _, cam, _, kw = scene
    if not native.available():
        fail("the native SPZ codec did not build or load (utils/native.py)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.spz")
        spz, read, decoded, ms = spz_round_trip(soa, path)
        nbytes = os.path.getsize(path)
        with numpy_codecs():
            spz_np, _, _, ms_np = spz_round_trip(soa, path)
            decoded_np = GaussianSoA.from_spz(read)
    if not (spz_np.header == spz.header and all(
            np.array_equal(getattr(spz_np, f), getattr(spz, f))
            for f in SPZ_FIELDS)):
        fail("SPZ encode: the native and numpy codecs differ")
    ties = scale_ties(spz.scales, spz_np.scales, soa.scale)
    if not all(getattr(decoded, f).tobytes() == getattr(decoded_np, f)
               .tobytes() for f in ("rot", "pos", "color", "sh")):
        fail("SPZ decode: the native and numpy codecs differ")
    scale_ulps = np.abs(decoded.scale.view(np.int32).astype(np.int64)
                        - decoded_np.scale.view(np.int32))
    if not scale_ulps.max() <= SCALE_ULPS:
        fail(f"SPZ decode: native and numpy scales differ by "
             f"{scale_ulps.max()} ulps")

    original = forward().image
    base = dict(background=kw["background"], pad_slack=kw["pad_slack"])
    notes, times = [], {}
    for name, layout in (("default", GaussianLayout()),
                         ("sh norm8", SPZ_QUANT_LAYOUT)):
        image, up_ms, fwd_ms, launches, e3, e8 = check_spz_render(
            device, decoded, layout, cam, base)
        times[name] = (up_ms, fwd_ms)
        diff = (image - original).abs()
        notes.append(f"{name} layout: launches {launches}, K1/K2 "
                     f"bit-identical, K3 max abs err {e3:.3g} (tol "
                     f"{K3_TOL}), K8 unpack max abs err {e8:.3g}, image vs "
                     f"phase 4's of the original max abs diff "
                     f"{float(diff.max()):.4g} mean {float(diff.mean()):.4g} "
                     f"(SPZ is lossy: a record, not a gate)")
        del image, diff

    small = read_spz(EXAMPLE_SPZ)
    ssoa = GaussianSoA.from_spz(small)
    sbuf = GaussiansBuffer.new(ssoa, GaussianLayout(), device)
    scam = Camera.look_at(eye=(0.0, -0.5, -4.0), target=(0.0, 0.0, 0.0),
                          fov_y=0.9, **SPZ_SMALL)
    sres = render_gaussians(sbuf, scam, GaussianTransform(sh_deg=3),
                            background=BG)
    means, cov6, color, opac, sh = unpack_gaussians(sbuf.data)
    sref = render_reference(means, cov6, color, opac, scam, sh=sh, sh_deg=3,
                            background=BG)
    serr = float((sres.image - sref).abs().max())
    if bool(sres.overflow) or not serr <= SLICE_TOL:
        fail(f"examples/model.spz differs from render_reference by {serr}")
    if not float((sres.image - torch.tensor(BG, device=device)).abs()
                 .max()) > 0.1:
        fail("examples/model.spz rendered nothing")

    print(f"phase 22 SPZ slice ({len(soa)} gaussians, v{spz.header.version} "
          f"sh_deg {spz.header.sh_degree} frac {spz.header.fractional_bits}, "
          f"{cam.width}x{cam.height}, pad_slack {kw['pad_slack']}): native "
          f"codec loaded; native vs numpy: encode bit-identical but "
          f"{ties} of {spz.scales.size} scales one step apart on a rounding "
          f"tie (tol {TIE_TOL} from a half), decode of the same bytes "
          f"bit-identical but {int((scale_ulps > 0).sum())} scales within "
          f"{scale_ulps.max()} ulp (tol {SCALE_ULPS}); read back == "
          f"written; " + "; ".join(notes)
          + f"; examples/model.spz ({len(small)} gaussians, v"
          f"{small.header.version}) at {scam.width}x{scam.height} vs "
          f"render_reference max abs err {serr:.3g} (tol {SLICE_TOL})",
          flush=True)
    print(f"phase 22 times ({card}), host ms at {len(soa)} gaussians: "
          + ", ".join(f"{step} native {ms[step]:.1f} / numpy "
                      f"{ms_np[step]:.1f}" for step in ms)
          + f"; file {nbytes} bytes (gzip level 9); upload and render ms: "
          + ", ".join(f"{name} upload {t[0]:.1f} render {t[1]:.3f}"
                      for name, t in times.items()), flush=True)


# Phase 23: the attribution tools' arguments (the bench scene and
# capacities, 3 calls a reading: a profiled session of a training step's
# host operations takes seconds to read back), the kernels each stage of
# theirs must launch, and the stage sequences whose device operations
# must not decrease (prefixes).
TOOL_ARGS = ["--iters", "3"]
PREFIXES = (
    ("profile_components", FORWARD_PREFIX + ("fwd", "step")),
    ("bench_bin", bench_bin.BIN_STAGES),
)


def phase_tools(step_profile, card: str):
    """Phase 23 (see the module's docstring)."""
    t0 = time.perf_counter()
    runs, seconds = {}, {}
    for tool, main, argv in (
            ("profile_components", profile_components.main, TOOL_ARGS),
            ("bench_bin", bench_bin.main, TOOL_ARGS),
            ("bench_bwd --newtail", bench_bwd.main, TOOL_ARGS
             + ["--newtail"]),
            ("bench_nscale", bench_nscale.main, TOOL_ARGS)):
        t = time.perf_counter()
        runs[tool] = main(argv)
        seconds[tool] = time.perf_counter() - t
    name = torch.cuda.get_device_name(0)
    for tool, out in runs.items():
        if out["device"] != name:
            fail(f"{tool} ran on {out['device']}, not {name}")
        for stage, r in out["stages"].items():
            if r["overflow"]:
                fail(f"{tool} {stage} overflowed its capacities")
            missing = [k for k in TOOL_KERNELS.get(stage, ())
                       if r["launches"].get(k, 0) < 1]
            if missing:
                fail(f"{tool} {stage} did not launch {missing}: "
                     f"{r['launches']}")
    for tool, order in PREFIXES:
        ops = [runs[tool]["stages"][s]["ops"] for s in order]
        if any(b < a for a, b in zip(ops, ops[1:])):
            fail(f"{tool}: the operations of {order} decrease: {ops}")
    stages = runs["profile_components"]["stages"]
    glue = runs["profile_components"]["derived"]["glue_bwd"]
    print(f"phase 23 attribution tools ({len(runs)} runs, "
          f"{sum(len(o['stages']) for o in runs.values())} stages, "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + "): no overflow, kernels "
          "launched where due, prefix operations "
          + "; ".join(f"{tool} " + " <= ".join(
              str(runs[tool]["stages"][s]["ops"]) for s in order)
              for tool, order in PREFIXES)
          + f"; step stage {stages['step']['device_ms']:.3f} ms device, "
          f"{stages['step']['ops']} operations, host enqueue "
          f"{stages['step']['enqueue_ms']:.3f} / wall "
          f"{stages['step']['wall_ms']:.3f} ms (phase 9: "
          f"{step_profile[0]:.3f} ms, {step_profile[1]} operations); "
          f"glue_bwd {glue['device_ms']:.3f} ms; {card}", flush=True)


# Phase 24: the four synthetic measurement tools at the JAX tools' sizes,
# 10 calls a reading (late in this process the profiler loses marker
# kernels: with 3 calls a reading one lost marker can leave no two calls
# alike in all three sessions, as it did for segment_sum9), and the
# scaling tool at its defaults with 3 timed steps. Each tool's inputs are
# freed when its main returns.
DATA_TOOLS = (
    ("bench_sort_shapes", bench_sort_shapes.main),
    ("bench_irregular_ops", bench_irregular_ops.main),
    ("bench_reorder", bench_reorder.main),
    ("bench_reorder2", bench_reorder2.main),
)
DATA_TOOL_ARGS = ["--iters", "10"]
SCALING_ARGS = ["--iters", "3"]


def phase_data_tools(card: str):
    """Phase 24 (see the module's docstring)."""
    t0 = time.perf_counter()
    runs, seconds = {}, {}
    for tool, main in DATA_TOOLS:
        t = time.perf_counter()
        runs[tool] = main(DATA_TOOL_ARGS)
        seconds[tool] = time.perf_counter() - t
    name = torch.cuda.get_device_name(0)
    for tool, out in runs.items():
        if out["device"] != name:
            fail(f"{tool} ran on {out['device']}, not {name}")
        for stage, r in out["stages"].items():
            if r["ops"] < 1:
                fail(f"{tool} {stage!r} ran no device operation")
    t = time.perf_counter()
    sc = scaling_efficiency.main(SCALING_ARGS)
    seconds["scaling_efficiency"] = time.perf_counter() - t
    if sc["device"] != name:
        fail(f"scaling_efficiency ran on {sc['device']}, not {name}")
    if sc["efficiency_1dev"] != 1.0:
        fail(f"scaling_efficiency: efficiency_1dev "
             f"{sc['efficiency_1dev']}, not 1")
    if not np.isfinite(sc["sharding_overhead_1dev"]):
        fail(f"scaling_efficiency: sharding_overhead_1dev "
             f"{sc['sharding_overhead_1dev']}")
    for d, ranks in sc["launches"].items():
        for rank, got in enumerate(ranks):
            missing = [k for k in RENDER_KERNELS if got.get(k, 0) < 1]
            if missing:
                fail(f"scaling_efficiency D={d} rank {rank} did not launch "
                     f"{missing}: {got}")
    stages = [r for out in runs.values() for r in out["stages"].values()]
    sizes = sorted(int(d) for d in sc["launches"])
    print(f"phase 24 measurement tools ({len(runs) + 1} runs, "
          f"{len(stages)} stages, {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"): every stage on the card with device operations (fewest "
          f"{min(r['ops'] for r in stages)}), profiler sessions "
          f"{sum(r['profiler_sessions'] for r in stages)} for "
          f"{len(stages)} stages; scaling ({sc['backend']}, D "
          f"{sizes}): plain step {sc['plain_1dev_ms']:.3f} ms, sharded D=1 "
          f"{sc['sharded_1dev_ms']:.3f} ms, overhead "
          f"{sc['sharding_overhead_1dev']:.4f}, route build (D=8) "
          f"{sc['route_build_8dst_ms']:.3f} ms, efficiency "
          + ", ".join(f"D={d} {sc[f'efficiency_{d}dev']:.4f}"
                      for d in sizes)
          + f", K1-K6 launched on every rank; {card}", flush=True)


FORWARD_KERNELS = ("expand_row_table", "expand_fragment_records",
                   "sorted_fetch", "rasterize_fwd")
RENDER_KERNELS = FORWARD_KERNELS + ("rasterize_bwd", "segment_sums",
                                    "uncompact")
SH_KERNELS = ("sh_color_fwd", "sh_color_bwd")  # K12, with SH only
# The kernels whose errors phases 2-8 carry in order, K2's row form and K1's
# row-stream form among them (the render path runs neither).
ERR_KERNELS = ("expand_rows", "expand_row_table", "expand_fragments",
               "rasterize_fwd", "rasterize_bwd", "segment_sums", "uncompact")
TOOL_KERNELS = {
    "bin": FORWARD_KERNELS[:3],
    "gather": ("rasterize_fwd",),
    "kernel_fwd": ("rasterize_fwd",),
    "kernel_fwd_bwd": ("rasterize_fwd", "rasterize_bwd"),
    "reorder": ("segment_sums", "uncompact"),
    "step": RENDER_KERNELS,
    "rows": ("expand_row_table",),
    "expand": FORWARD_KERNELS[:2],
    "sort": FORWARD_KERNELS[:3],
    "ranges": FORWARD_KERNELS[:3],
}
KERNELS = (
    ("expand_rows", "wgpu_3dgs_core_tpu_torch/csrc/expand.cu",
     "wgpu_3dgs_core_tpu/ops/expand.py:571"),
    ("expand_row_table", "wgpu_3dgs_core_tpu_torch/csrc/expand.cu",
     "wgpu_3dgs_core_tpu/ops/expand.py:571"),
    ("expand_fragments", "wgpu_3dgs_core_tpu_torch/csrc/expand.cu",
     "wgpu_3dgs_core_tpu/ops/expand.py:202"),
    ("expand_fragment_records", "wgpu_3dgs_core_tpu_torch/csrc/expand.cu",
     "wgpu_3dgs_core_tpu/ops/expand.py:202"),
    ("sorted_fetch", "wgpu_3dgs_core_tpu_torch/csrc/expand.cu", None),
    ("rasterize_fwd", "wgpu_3dgs_core_tpu_torch/csrc/rasterize.cu",
     "wgpu_3dgs_core_tpu/ops/rasterize.py:294"),
    ("rasterize_bwd", "wgpu_3dgs_core_tpu_torch/csrc/rasterize.cu",
     "wgpu_3dgs_core_tpu/ops/rasterize.py:442"),
    ("segment_sums", "wgpu_3dgs_core_tpu_torch/csrc/segreduce.cu",
     "wgpu_3dgs_core_tpu/ops/segreduce.py:105"),
    ("uncompact", "wgpu_3dgs_core_tpu_torch/csrc/segreduce.cu",
     "wgpu_3dgs_core_tpu/ops/segreduce.py:222"),
    ("expand_fragments_bbox", "wgpu_3dgs_core_tpu_torch/csrc/expand.cu",
     "wgpu_3dgs_core_tpu/ops/expand.py:191"),
    ("kernel_bundle", "wgpu_3dgs_core_tpu_torch/csrc/bundle.cuh",
     "wgpu_3dgs_core_tpu/ops/kernel_bundle.py:148"),
    ("rasterize_variants", "wgpu_3dgs_core_tpu_torch/csrc/variants.cu",
     "tools/bench_kernel_variants.py:228"),
    ("segment_sum_variants", "wgpu_3dgs_core_tpu_torch/csrc/variants.cu",
     "tools/bench_segsum.py:92"),
    ("probe_dyngrid", "wgpu_3dgs_core_tpu_torch/csrc/probe_dyngrid.cu",
     "tools/probe_dyngrid.py:17"),
    ("sh_color_fwd", "wgpu_3dgs_core_tpu_torch/csrc/sh.cu", None),
    ("sh_color_bwd", "wgpu_3dgs_core_tpu_torch/csrc/sh.cu", None),
)


def run(device: torch.device, card: str):
    t0 = time.perf_counter()
    cases = bundle_cases(device)
    phase_build(bundle_sources(cases))
    mid = mid_scene(device)
    errs, errs_fetch = phase_kernels(mid)
    phase_spec(device)
    scene = bench_scene(device)
    ms, errs, e_fetch, forward, fwd_ms, inp = phase_full(device, errs, scene)
    errs_fetch = {k: max(v, e_fetch[k]) for k, v in errs_fetch.items()}
    phase_profile(forward, "5", "forward")
    errs = errs + phase_backward_kernels(device, mid)
    phase_spec_grads(device)
    launches, ms_bwd, errs, train_step, bi = phase_train(device, scene, inp,
                                                         fwd_ms, errs)
    ms.update(ms_bwd)
    errs_sh, ms_sh, bounds_sh = phase_sh_color(scene)
    ms.update(ms_sh)
    step_profile = phase_profile(train_step, "9", "training step")
    bounds, counts = kernel_bounds(inp, bi)
    bounds.update(bounds_sh)
    print(f"bounds (H100 SXM: {HBM_BYTES_S:.3g} B/s, {FP32_FLOPS_S:.3g} "
          f"FP32 flop/s): {counts['drawn']} drawn fragments, "
          f"{counts['evaluated']} evaluated and {counts['blended']} blended "
          f"(fragment, pixel) pairs, {counts['n_live']} gaussians with "
          f"fragments", flush=True)
    errs = dict(zip(ERR_KERNELS, errs), **errs_sh, **errs_fetch)
    errs["kernel_bundle"] = phase_bundles(cases)
    (launches["kernel_bundle"], err8, ms["kernel_bundle"],
     bounds["kernel_bundle"]) = phase_core(device, scene[0])
    errs["kernel_bundle"] = max(errs["kernel_bundle"], err8)
    (launches["expand_fragments_bbox"], errs["expand_fragments_bbox"],
     ms["expand_fragments_bbox"],
     bounds["expand_fragments_bbox"]) = phase_binning(device, mid, scene)
    t12 = time.perf_counter()
    (launches["probe_dyngrid"], errs["probe_dyngrid"], ms["probe_dyngrid"],
     bounds["probe_dyngrid"]) = phase_probe(device)
    (launches["segment_sum_variants"], errs["segment_sum_variants"],
     ms["segment_sum_variants"]) = phase_segsum_variants(
         device, bi, bounds["segment_sums"][0])
    bounds["segment_sum_variants"] = bounds["segment_sums"]  # its full level
    (launches["rasterize_variants"], errs["rasterize_variants"],
     ms["rasterize_variants"]) = phase_raster_variants(device, inp, mid)
    bounds["rasterize_variants"] = bounds["rasterize_fwd"]
    phase_port_bench(device)
    phase_grad_parity(device)
    phase_ellipse(scene)
    phase_raster_redesign(device, inp, bi, counts, bounds)
    t19 = time.perf_counter()
    one = phase_sharded_one(device, scene)
    phase_sharded_ranks(device, scene, one, mid)
    t21 = time.perf_counter()
    phase_spz(device, scene, forward, card)
    t22 = time.perf_counter()
    phase_tools(step_profile, card)
    t23 = time.perf_counter()
    phase_data_tools(card)
    t24 = time.perf_counter()
    print(f"wall time: phases 1-12 {t12 - t0:.1f} s, phases 13-19 "
          f"{t19 - t12:.1f} s, phases 20-21 {t21 - t19:.1f} s, phase 22 "
          f"{t22 - t21:.1f} s, phase 23 {t23 - t22:.1f} s, phase 24 "
          f"{t24 - t23:.1f} s; "
          f"torch.profiler: "
          + ", ".join(f"{k} {v}" for k, v in PROFILER_STATS.items()),
          flush=True)
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ms[name][0], "plain_ms": ms[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": ms[name][2], "call_ms": ms[name][3]}
        for name, src, rep in KERNELS
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this check runs on a GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 reference
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device: {name}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    summary = run(device, smi)
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
