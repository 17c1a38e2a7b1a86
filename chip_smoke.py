"""Smoke run of the PyTorch + CUDA port (wgpu_3dgs_core_tpu_torch) on a GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Phases, one line each:

1. build the port's kernels from its csrc/ sources (one nvcc per source,
   all started together);
2. hold each forward kernel against its plain torch version on the card,
   on a mid scene (65,536 gaussians, 512x512): K1 and K2 bit for bit, K3
   within 3e-5 (the card's exp and FMA contraction differ from torch's);
3. hold the forward slice (render_gaussians through the kernels) against
   the brute-force reference renderer on the card (2,500 gaussians,
   256x192) within 1e-4 max abs: the tiled and brute-force renderers sum
   in different orders;
4. render the bench scene (1,000,000 gaussians, 1920x1080, sh_deg 3,
   pad_slack 0.65) through render_gaussians, check it, show that each
   forward kernel ran on that path, and time it and each kernel beside its
   plain version (median of 10 after 2 warm-ups, CUDA events);
5. profile the bench-scene forward: host enqueue time against wall time
   of back-to-back forwards, and torch.profiler's device kernels per
   forward (count, time, time by kind);
6. hold each backward kernel against its plain version on the mid scene
   with a random cotangent: K4 within 1e-4 of the largest gradient of its
   row, K5 within 1e-5 of the largest sum of its row, K6 bit for bit; two
   backward passes of the slice give bit-identical gradients;
7. hold the slice's gradients (means, quats, scales, colour, opacity, sh;
   loss sum((image - target)^2)) against autograd of render_reference on
   the card, on the spec scene, within 1e-4 of each parameter's largest
   gradient;
8. the training step on the bench scene: forward + backward of mean(
   image^2) w.r.t. (means, cov3d, colour, opacity, sh), checked (no
   overflow, finite gradients, all six kernels launched on that path) and
   timed beside the forward; three Adam steps of make_train_step on
   TrainableGaussians at the same size; each backward kernel held against
   its plain version and timed beside it and, for K5 and K6, beside the
   one PyTorch call that computes the same function;
9. the profile of phase 5 for the training step.

Then a JSON line of the kernels (launches on the training step, errors,
times, and the bound: the least time the card could take for the same
work), the card's name and power limit from nvidia-smi, and last
{"ok": true, "device": {...}}. Any failure raises and exits nonzero; so
does a machine without a CUDA card. The run uses one card: the first that
CUDA_VISIBLE_DEVICES names, else card 0.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# Before torch starts CUDA: this run, and its contract line, see one card.
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from wgpu_3dgs_core_tpu_torch import (  # noqa: E402
    Camera,
    GaussianLayout,
    GaussiansBuffer,
    GaussianSoA,
    GaussianTransform,
    TrainableGaussians,
    launch_counts,
    make_train_step,
    measure_max_fragments,
    measure_max_rows,
    render,
    render_gaussians,
    render_reference,
    reset_launch_counts,
)
from wgpu_3dgs_core_tpu_torch.ops import cuda  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import expand as ex  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import rasterize as ra  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops import segreduce as sr  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops.transforms import (  # noqa: E402
    cov3d_from_rot_scale,
)
from wgpu_3dgs_core_tpu_torch.render.train import FIT_HEADROOM  # noqa: E402
from wgpu_3dgs_core_tpu_torch.ops.binning import (  # noqa: E402
    CHUNK,
    bin_splats_attrs,
    gaussian_table,
    num_tiles,
    pad_schedule,
    padded_capacity,
    row_capacity,
    row_table,
)
from wgpu_3dgs_core_tpu_torch.render.renderer import (  # noqa: E402
    project_and_color,
    tile_local_stream,
    unpack_gaussians,
)
from wgpu_3dgs_core_tpu_torch.utils.numeric import cast_u8  # noqa: E402

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
SLICE_TOL = 1e-4
# Backward bars, each relative to the largest value of the row or
# parameter compared (tests/test_render.py's gradient bar): K4 and the
# slice's gradients sum in another order than their plain versions; K5's
# plain version sums in f64.
K4_TOL = 1e-4
K5_TOL = 1e-5
GRAD_TOL = 1e-4
PROFILE_FWD = 10  # forwards (or training steps) per profile measurement
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
# Device kernels by kind, for the profile: (kind, substring of the name).
KERNEL_KINDS = (
    ("K3 rasterize_fwd", "rasterize_fwd_kernel"),
    ("K4 rasterize_bwd", "rasterize_bwd_kernel"),
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
    ("elementwise", "elementwise"),
)


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


def cuda_ms(fn, warmup=2, iters=10) -> float:
    """Median time of a callable by CUDA events around it, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(args, cam, max_fragments, max_rows, pad_slack, sh_deg=3,
                  background=BG):
    """The inputs render() hands K1, K2 and K3, made by the port's own
    stages with render()'s capacities."""
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
    stream, attrs_sorted, _ = bin_splats_attrs(
        splats.xy, splats.extent, splats.depth, splats.mask, attr_cols,
        tiles_x, tiles_y, f_cap, max_rows=max_rows,
    )
    t_total = tiles_x * tiles_y
    sched = pad_schedule(stream, padded_capacity(f_cap, t_total, pad_slack))
    frags = tile_local_stream(attrs_sorted, stream.tile_id, tiles_x)
    return dict(
        k1=(table, total_rows, r_cap),
        k2=(rtab, total, f_cap, tiles_x, t_total),
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
    """K1 and K2 against their plain versions: every output bit for bit.
    Returns the max abs difference of the float outputs (0 when equal)."""
    k1 = ex.expand_rows(*inp["k1"])
    p1 = ex.expand_rows_plain(*inp["k1"])
    if not (torch.equal(k1.ints, p1.ints)
            and torch.equal(bits(k1.attrs), bits(p1.attrs))):
        fail("K1 expand_rows differs from its plain version")
    k2 = ex.expand_fragments_with_attrs(*inp["k2"])
    p2 = ex.expand_fragments_with_attrs_plain(*inp["k2"])
    if not (torch.equal(k2[0], p2[0]) and torch.equal(k2[1], p2[1])
            and torch.equal(bits(k2[2]), bits(p2[2]))):
        fail("K2 expand_fragments_with_attrs differs from its plain version")
    return (float((k1.attrs - p1.attrs).abs().max()),
            float((k2[2] - p2[2]).abs().max()))


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


def phase_build():
    info = cuda.build()
    cuda.library()
    regs = [ln.strip() for ln in info.log.splitlines() if "registers" in ln]
    print(f"phase 1 build: {info.seconds:.1f} s nvcc sm_90a -> "
          f"{info.path.name}; ptxas: {' | '.join(regs)}", flush=True)


def mid_scene(device):
    """The mid scene: its camera, render arguments, measured capacities
    and the kernels' inputs for its stream."""
    cfg = MID
    soa = to_soa(*draw_scene(cfg["n"], cfg["seed"], **BENCH_SCENE))
    buf = GaussiansBuffer.new(soa, GaussianLayout(), device)
    cam = Camera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                         width=cfg["width"], height=cfg["height"], fov_y=0.9)
    args = unpack_gaussians(buf.data)
    caps = (measure_max_fragments(args[0], args[1], args[3], cam),
            measure_max_rows(args[0], args[1], args[3], cam))
    return cam, args, caps, kernel_inputs(args, cam, *caps, pad_slack=1.0)


def phase_kernels(mid):
    cfg = MID
    inp = mid[3]
    e1, e2 = compare_expand(inp)
    e3 = compare_k3(inp)
    print(f"phase 2 kernels vs plain ({cfg['n']} gaussians, "
          f"{cfg['width']}x{cfg['height']}, {int(inp['total'])} fragments): "
          f"K1 bit-identical, K2 bit-identical, K3 max abs err {e3:.3g} "
          f"(tol {K3_TOL})", flush=True)
    return e1, e2, e3


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
    kw = dict(background=(0.0, 0.0, 0.0),
              max_fragments=measure_max_fragments(args[0], args[1], args[3],
                                                  cam),
              max_rows=measure_max_rows(args[0], args[1], args[3], cam),
              pad_slack=0.65)
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
    e1, e2 = compare_expand(inp)
    lens = inp["k3"][2]
    densest = int(torch.argmax(lens))
    rng = np.random.default_rng(0)
    picks = rng.choice(lens.shape[0], 63, replace=False).tolist()
    tiles = sorted(set(picks) | {densest})
    e3 = compare_k3(inp, tiles=tiles)
    errs = (max(errs[0], e1), max(errs[1], e2), max(errs[2], e3))

    torch.cuda.synchronize(device)
    reset_launch_counts()
    res = forward()
    torch.cuda.synchronize(device)
    launches = launch_counts()
    ran = {k: v for k, v in launches.items() if k in FORWARD_KERNELS}
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
    k1, k2, k3 = inp["k1"], inp["k2"], inp["k3"]
    ms = {
        "expand_rows": (cuda_ms(lambda: ex.expand_rows(*k1)),
                        cuda_ms(lambda: ex.expand_rows_plain(*k1)), None),
        "expand_fragments": (
            cuda_ms(lambda: ex.expand_fragments_with_attrs(*k2)),
            cuda_ms(lambda: ex.expand_fragments_with_attrs_plain(*k2)), None),
        "rasterize_fwd": (cuda_ms(lambda: ra.rasterize_tiles_fwd(*k3)),
                          cuda_ms(lambda: ra.rasterize_tiles_fwd_plain(*k3)),
                          None),
    }
    mpix = cfg["width"] * cfg["height"] / fwd_ms / 1e3
    print(f"phase 4 full slice ({cfg['n']} gaussians, {cfg['width']}x"
          f"{cfg['height']}, sh_deg 3, pad_slack {pad_slack}): capacities "
          f"{max_fragments} fragments / {max_rows} rows, live {frags} "
          f"fragments / {rows} rows, overflow False, launches {ran}, "
          f"K3 on {len(tiles)} tiles incl. densest {densest} "
          f"({int(lens[densest])} fragments) max abs err {e3:.3g}; forward "
          f"{fwd_ms:.3f} ms ({mpix:.1f} Mpix/s); kernel/plain ms "
          + ", ".join(f"{k} {a:.3f}/{b:.3f}" for k, (a, b, _) in ms.items()),
          flush=True)
    return ms, errs, forward, fwd_ms, inp


def kernel_kind(name: str) -> str:
    for kind, key in KERNEL_KINDS:
        if key in name:
            return kind
    return "other"


def phase_profile(device, fn, phase: str, what: str):
    """Where the time of ``fn`` (a bench-scene forward or training step)
    goes: the host's enqueue time against the wall time of back-to-back
    calls (host-bound when they are equal), and the device kernels per
    call by torch.profiler. Busy share = device kernel time / wall time."""
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(PROFILE_FWD):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    enqueue_ms = (t1 - t0) * 1e3 / PROFILE_FWD
    wall_ms = (t2 - t0) * 1e3 / PROFILE_FWD
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_FWD):
            fn()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        fail("torch.profiler recorded no device kernel")
    by_kind: dict[str, float] = {}
    for e in kernels:
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.time_range.elapsed_us()
    per_call = {k: v / 1e3 / PROFILE_FWD for k, v in
                sorted(by_kind.items(), key=lambda kv: -kv[1])}
    device_ms = sum(per_call.values())
    print(f"phase {phase} profile ({PROFILE_FWD} back-to-back {what}s): "
          f"host enqueue {enqueue_ms:.3f} ms/{what}, wall {wall_ms:.3f} "
          f"ms/{what}; {len(kernels) / PROFILE_FWD:.1f} device kernels and "
          f"{device_ms:.3f} ms of device kernel time per {what} (busy "
          f"share {device_ms / wall_ms:.2f}); ms/{what} by kind: "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_call.items()),
          flush=True)


def leaves(args):
    return [t.detach().clone().requires_grad_(True) for t in args]


def grads_of(args, cam, target, **kw):
    """Gradients of sum((render - target)^2) w.r.t. every argument."""
    res = render(*args[:4], cam, sh=args[4], sh_deg=3, **kw)
    if bool(res.overflow):
        fail("backward scene overflowed its capacities")
    loss = torch.sum((res.image - target) ** 2)
    return torch.autograd.grad(loss, args)


def phase_backward_kernels(device, mid):
    cfg = MID
    cam, args, caps, inp = mid
    errs, (n4, n5) = compare_backward(backward_inputs(inp))

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
          f"{n4:.3g} (tol {K4_TOL}); K5 max abs err {errs[1]:.3g}, "
          f"normalized {n5:.3g} (tol {K5_TOL}); K6 bit-identical; two "
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
    before it is above T_MIN, and blend it there when it is kept. Counted
    with the plain version's arithmetic."""
    dev = frags.device
    p = torch.arange(ra.PIX, device=dev)
    px = (p % 16).float() + 0.5
    py = torch.div(p, 16, rounding_mode="floor").float() + 0.5
    evaluated = blended = 0
    tiles = torch.arange(tile_start.shape[0], device=dev)
    for _, valid, idx in ra._tile_batches(tile_start, draw_len, tiles):
        alpha, ok = ra._frag_alpha(frags[:, idx][..., None], px, py,
                                   cutoff_sq, mode)
        keep = ok & valid[..., None]
        t = torch.cumprod(1.0 - torch.where(keep, alpha, 0.0), dim=1)
        t_before = torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], dim=1)
        live = (t_before > ra.T_MIN) & valid[..., None]
        evaluated += int(live.sum())
        blended += int((live & keep).sum())
    return evaluated, blended


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
    evaluated, blended = rasterizer_pairs(frags, tile_start, draw_len)
    return {
        "expand_rows": bound(
            f32 * ((ex.TAB_ROWS + table.attrs.shape[0]) * n + 1)
            + f32 * (ex.ROW_INTS + table.attrs.shape[0]) * r_cap, 0),
        "expand_fragments": bound(
            f32 * ((ex.TAB_ROWS + rtab.attrs.shape[0]) * rows + 1)
            + f32 * (2 + rtab.attrs.shape[0] + 1) * f_cap, 0),
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
            n_live=n_live)


def library_calls(bi):
    """The one PyTorch call computing K5's function (segment_reduce over
    the drawn slots, their gradient rows gathered in key order first) and
    K6's (index_copy_ onto zeros), on the same inputs."""
    keys, perm, dfrag, gid_col, n = bi["k5"]
    comp = bi["k6"][0]
    lo = torch.searchsorted(keys, gid_col)
    hi = torch.searchsorted(keys, gid_col, right=True)
    lengths = torch.where(gid_col < n, hi - lo, 0)
    drawn = int(lengths.sum())
    data = dfrag[:, perm[:drawn]].T.contiguous()
    n_live = int((gid_col < n).sum())
    live_gids = gid_col[:n_live].long()
    live_comp = comp[:, :n_live]

    def k5():
        return torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                                    unsafe=True)

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
    launches = launch_counts()
    if min(launches.values()) < 1:
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
    caps = dict(
        max_fragments=measure_max_fragments(means, cov6, opacity, cam,
                                            headroom=FIT_HEADROOM),
        max_rows=measure_max_rows(means, cov6, opacity, cam,
                                  headroom=FIT_HEADROOM))
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
    errs = errs[:3] + tuple(max(a, b) for a, b in zip(errs[3:], e_full))
    lib5, lib6 = library_calls(bi)
    k4, k5, k6 = bi["k4"], bi["k5"], bi["k6"]
    ms = {
        "rasterize_bwd": (cuda_ms(lambda: ra.rasterize_tiles_bwd(*k4)),
                          cuda_ms(lambda: ra.rasterize_tiles_bwd_plain(*k4)),
                          None),
        "segment_sums": (
            cuda_ms(lambda: sr.segment_sums_sorted(*k5)),
            cuda_ms(lambda: sr.segment_sums_sorted_plain(*k5)),
            cuda_ms(lib5)),
        "uncompact": (cuda_ms(lambda: sr.uncompact_columns(*k6)),
                      cuda_ms(lambda: sr.uncompact_columns_plain(*k6)),
                      cuda_ms(lib6)),
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
          f"bit-identical; kernel/plain/library ms "
          + ", ".join(f"{k} {a:.3f}/{b:.3f}/{c:.3f}" if c is not None
                      else f"{k} {a:.3f}/{b:.3f}"
                      for k, (a, b, c) in ms.items()),
          flush=True)
    return launches, ms, errs, lambda: step()[2], bi


FORWARD_KERNELS = ("expand_rows", "expand_fragments", "rasterize_fwd")
KERNELS = (
    ("expand_rows", "wgpu_3dgs_core_tpu_torch/csrc/expand.cu",
     "wgpu_3dgs_core_tpu/ops/expand.py:571"),
    ("expand_fragments", "wgpu_3dgs_core_tpu_torch/csrc/expand.cu",
     "wgpu_3dgs_core_tpu/ops/expand.py:202"),
    ("rasterize_fwd", "wgpu_3dgs_core_tpu_torch/csrc/rasterize.cu",
     "wgpu_3dgs_core_tpu/ops/rasterize.py:294"),
    ("rasterize_bwd", "wgpu_3dgs_core_tpu_torch/csrc/rasterize.cu",
     "wgpu_3dgs_core_tpu/ops/rasterize.py:442"),
    ("segment_sums", "wgpu_3dgs_core_tpu_torch/csrc/segreduce.cu",
     "wgpu_3dgs_core_tpu/ops/segreduce.py:105"),
    ("uncompact", "wgpu_3dgs_core_tpu_torch/csrc/segreduce.cu",
     "wgpu_3dgs_core_tpu/ops/segreduce.py:222"),
)


def run(device: torch.device):
    phase_build()
    mid = mid_scene(device)
    errs = phase_kernels(mid)
    phase_spec(device)
    scene = bench_scene(device)
    ms, errs, forward, fwd_ms, inp = phase_full(device, errs, scene)
    phase_profile(device, forward, "5", "forward")
    errs = errs + phase_backward_kernels(device, mid)
    phase_spec_grads(device)
    launches, ms_bwd, errs, train_step, bi = phase_train(device, scene, inp,
                                                         fwd_ms, errs)
    ms.update(ms_bwd)
    phase_profile(device, train_step, "9", "training step")
    bounds, counts = kernel_bounds(inp, bi)
    print(f"bounds (H100 SXM: {HBM_BYTES_S:.3g} B/s, {FP32_FLOPS_S:.3g} "
          f"FP32 flop/s): {counts['drawn']} drawn fragments, "
          f"{counts['evaluated']} evaluated and {counts['blended']} blended "
          f"(fragment, pixel) pairs, {counts['n_live']} gaussians with "
          f"fragments", flush=True)
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err, "ms": ms[name][0],
         "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": ms[name][2]}
        for (name, src, rep), err in zip(KERNELS, errs)
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
    summary = run(device)
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
