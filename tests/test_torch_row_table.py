"""K1's row-table form (``ops/binning.py::expand_row_table``): the
per-gaussian table straight into the per-row table K2 reads, each row's
exact tile interval computed inside the row expansion.

Its spec is ``row_table(expand_rows_plain(...))``; on CPU tensors the
launcher is that composition. The CPU cases hold the launcher's contract
on the bicycle-6m configuration's slab draw, a row stream truncated by its
capacity, an empty table, ELLIPSE binning and rows at the bbox clamp; the
post-processing of the CUDA route (the offsets' cumsum, the total) with
the kernel's writes stood in for; a float32 mirror of the kernel's
operations (one rounding each, torch's order, its clamp and NaN rules)
against ``_row_tile_span``; and the ``rows`` counter. The cases marked
``cuda`` hold the kernel bit for bit against the composition on the card
(6.1M gaussians, adversarial rows, rows with a non-finite centre or
conic) and skip without one. No JAX: run on the card with
``--noconftest``.
"""

import ctypes
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import scene as bench_scene
from wgpu_3dgs_core_tpu_torch.ops import binning as TB
from wgpu_3dgs_core_tpu_torch.ops import expand as TE
from wgpu_3dgs_core_tpu_torch.ops import rasterize as TR
from wgpu_3dgs_core_tpu_torch.ops.transforms import cov3d_from_rot_scale
from wgpu_3dgs_core_tpu_torch.render import renderer as R
from wgpu_3dgs_core_tpu_torch.utils import profiling as tpf

from .torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "benchmark" / "configs" / "bicycle-6m.json"
VIEW = ROOT / "benchmark" / "traffic" / "view.json"
SEED = 2_200_000_404
TX, TY = 40, 30  # the adversarial tables' grid


def bicycle_inputs(n, device, opacity_cull=True) -> dict:
    """The bicycle-6m slab draw at ``n`` gaussians seen from the view
    traffic's first camera: the binning's inputs (``binning``: xy,
    extent, depth, mask, attribute columns, tiles_x, tiles_y), the
    per-gaussian ``table`` and ``total_rows``, and the measured
    capacities (``max_fragments``, ``max_rows``, ``r_cap``)."""
    cfg = dict(json.loads(CONFIG.read_text()), gaussians=n)
    traffic = json.loads(VIEW.read_text())
    s = bench_scene.draw_scene(cfg, SEED, device)
    cam = bench_scene.port_camera(bench_scene.orbit_view(
        cfg, traffic, -float(traffic["azimuth_deg"]),
        float(traffic["elevation_deg"])))
    cov6 = cov3d_from_rot_scale(s["quats"], s["scales"])
    mode = (R.GaussianDisplayMode.SPLAT if opacity_cull
            else R.GaussianDisplayMode.ELLIPSE)
    with torch.no_grad():
        splats, rgb, op = R.project_and_color(
            s["means"], cov6, s["colour"], s["opacity"], cam, sh=s["sh"],
            sh_deg=3, display_mode=mode)
        cols = R.attribute_columns(splats.xy, splats.conic, rgb, op,
                                   splats.mask)
        binning = (splats.xy, splats.extent, splats.depth, splats.mask, cols,
                   *TB.num_tiles(cam.width, cam.height))
        table, total_rows = TB.gaussian_table(*binning,
                                              opacity_cull=opacity_cull)
        max_fragments, max_rows = R.measure_capacities(
            s["means"], cov6, s["opacity"], cam, display_mode=mode)
    return dict(binning=binning, table=table, total_rows=total_rows,
                max_fragments=max_fragments, max_rows=max_rows,
                r_cap=TB.row_capacity(max_rows))


def adversarial_table(device, non_finite=False):
    """A per-gaussian table of the rows the interval arithmetic finds
    hard, each gaussian over its whole bbox: near-singular conics (ca cc
    - cb^2 about 0, exactly 0 and below it), ry = 0 (the opacity cull's
    q = 0), ellipses wider than their bbox (the interval clamps at both
    edges), centres within ROW_TRIM_EPS of a tile edge, and seeded
    random conics. ``non_finite`` adds gaussians with a NaN or infinite
    centre, conic or ry over a fixed bbox; most of their rows have a NaN
    interval, which _row_tile_span makes an empty row."""
    rng = np.random.default_rng(7)
    rows = []  # (x, y, ca, cb, cc, ry, x0, y0, span_x, span_y)
    for k in range(48):  # near-singular: cb^2 = ca cc (1 + e)
        ca = np.float32(rng.uniform(0.01, 2.0))
        cc = np.float32(rng.uniform(0.01, 2.0))
        e = (0.0, 1e-7, -1e-7, 1e-3)[k % 4]
        cb = np.float32(np.sqrt(ca * cc * (1 + e)) * (1 if k % 2 else -1))
        rows.append((rng.uniform(40, 600), rng.uniform(40, 440), ca, cb, cc,
                     rng.uniform(2, 40), None))
    for _ in range(32):  # ry = 0
        rows.append((rng.uniform(40, 600), rng.uniform(40, 440),
                     rng.uniform(0.01, 1), rng.uniform(-0.1, 0.1),
                     rng.uniform(0.01, 1), 0.0, None))
    for _ in range(32):  # wide ellipse, narrow bbox: clamps at both edges
        rows.append((rng.uniform(100, 500), rng.uniform(100, 380),
                     rng.uniform(1e-4, 1e-3), rng.uniform(-1e-4, 1e-4),
                     rng.uniform(1e-3, 1e-2), rng.uniform(20, 60), 1))
    for k in range(64):  # centre within ROW_TRIM_EPS of a tile edge
        edge = 16.0 * rng.integers(2, 38)
        off = (-0.049, -0.02, -1e-4, 0.0, 1e-4, 0.02, 0.049, 0.05)[k % 8]
        rows.append((edge + off, 16.0 * rng.integers(2, 28) + off,
                     1.0 / 16.0, 0.0, 1.0 / 16.0,
                     rng.choice([4.0, 16.0 - 0.05, 12.0]), None))
    for _ in range(256):  # random conics
        a, c = rng.uniform(0.001, 1.0, 2)
        b = rng.uniform(-0.99, 0.99) * np.sqrt(a * c)
        rows.append((rng.uniform(0, 640), rng.uniform(0, 480), a, b, c,
                     rng.uniform(0.5, 50), None))
    cols = []
    for x, y, ca, cb, cc, ry, narrow in rows:
        det = max(ca * cc - cb * cb, 1e-20)
        rx = np.sqrt(max(9.0 * cc / det, 0.0)) if ry else 0.0
        x0 = int(np.clip((x - rx) // 16, 0, TX - 1))
        x1 = int(np.clip((x + rx) // 16 + 1, x0 + 1, TX))
        if narrow:  # a bbox two tiles inside the ellipse's
            x0, x1 = x0 + 2, max(x0 + 3, x1 - 2)
            x1 = min(x1, TX)
            x0 = min(x0, x1 - 1)
        y0 = int(np.clip((y - max(ry, 1.0)) // 16, 0, TY - 1))
        y1 = int(np.clip((y + max(ry, 1.0)) // 16 + 1, y0 + 1, TY))
        cols.append((x, y, ca, cb, cc, ry, x0, y0, x1 - x0, y1 - y0))
    if non_finite:  # (x, y, ca, cb, cc, ry) over the bbox (1, 1, 4, 2)
        inf, nan = float("inf"), float("nan")
        for bad in ((50, 40, 1e30, 1e30, 1e30, 10), (nan, 40, .5, 0, .5, 10),
                    (inf, 40, .5, 0, .5, 10), (50, 40, nan, 0, .5, 10),
                    (50, nan, .5, 0, .5, 10), (50, 40, .5, .1, .5, inf),
                    (50, 40, .5, nan, .5, 10), (-inf, 40, .5, 0, .5, 10)):
            cols.append(bad + (1, 1, 4, 2))
    c = np.array(cols, dtype=np.float64)
    n = c.shape[0]
    attr10 = np.zeros((10, n), np.float32)
    attr10[0:5] = c[:, 0:5].T
    attr10[5:9] = rng.uniform(0, 1, (4, n))
    attr10[9] = c[:, 5]
    ints = c[:, 6:10].astype(np.int64)
    t = lambda a, dt=torch.int32: torch.as_tensor(a, dtype=dt, device=device)
    counts = t(ints[:, 3])
    table = TE.build_tables(
        counts, t(ints[:, 2]), t(ints[:, 0]), t(ints[:, 1]),
        torch.arange(n, dtype=torch.int32, device=device),
        t(attr10, torch.float32), t(rng.permutation(n), torch.float32))
    return table, counts.sum(dtype=torch.int32)


def spec(table, total_rows, r_cap):
    return TB.row_table(TE.expand_rows_plain(table, total_rows, r_cap),
                        total_rows)


def assert_same_table(got, want):
    (gt, gtot), (wt, wtot) = got, want
    assert gt.ints.dtype == torch.int32 and gt.attrs.dtype == torch.float32
    assert gt.ints.is_contiguous() and gt.attrs.is_contiguous()
    assert torch.equal(gt.ints.cpu(), wt.ints.cpu())
    assert torch.equal(gt.attrs.cpu().view(torch.int32),
                       wt.attrs.cpu().view(torch.int32))
    assert gtot.shape == () and gtot.dtype == torch.int32
    assert int(gtot) == int(wtot)


@pytest.mark.parametrize("opacity_cull", [True, False],
                         ids=["splat", "ellipse"])
def test_row_table_is_the_composition_on_the_bicycle_slab(opacity_cull):
    """SPLAT (the opacity cull shrinks ry) and ELLIPSE (no cull): the
    launcher's table equals row_table(expand_rows_plain(...)), every live
    row with at least one tile, the padding rows as the live mask gives
    them."""
    b = bicycle_inputs(20_000, torch.device("cpu"), opacity_cull)
    table, total_rows, r_cap = b["table"], b["total_rows"], b["r_cap"]
    got = TB.expand_row_table(table, total_rows, r_cap)
    assert_same_table(got, spec(table, total_rows, r_cap))
    rows = int(total_rows)
    assert 0 < rows <= r_cap
    ints = got[0].ints
    assert bool((ints[TE.TAB_CNT, :rows] >= 1).all())
    assert not ints[TE.TAB_CNT, rows:].any()
    assert bool((ints[TE.TAB_SPAN, rows:] == 1).all())
    assert int(got[1]) == int(ints[TE.TAB_CNT].sum())


def test_row_table_truncated_by_its_capacity():
    """total_rows > r_cap: every slot is live, the table ends at r_cap."""
    table, total_rows = adversarial_table(torch.device("cpu"))
    r_cap = TB.row_capacity(512)
    assert int(total_rows) > r_cap
    got = TB.expand_row_table(table, total_rows, r_cap)
    assert_same_table(got, spec(table, total_rows, r_cap))
    assert got[0].ints.shape == (TE.TAB_ROWS, r_cap)
    assert bool((got[0].ints[TE.TAB_CNT] >= 1).all())


def test_row_table_of_an_empty_table():
    table = TE.SegmentTable(torch.zeros((TE.TAB_ROWS, 0), dtype=torch.int32),
                            torch.zeros((10, 0)))
    total_rows = torch.zeros((), dtype=torch.int32)
    got = TB.expand_row_table(table, total_rows, 512)
    assert_same_table(got, spec(table, total_rows, 512))
    assert int(got[1]) == 0 and got[0].attrs.shape == (9, 512)
    assert not got[0].ints[TE.TAB_CNT].any()


def test_row_table_at_the_bbox_clamp():
    """Rows whose ellipse is wider than their bbox take the whole bbox
    width; the adversarial table holds them beside the other hard rows."""
    table, total_rows = adversarial_table(torch.device("cpu"))
    r_cap = TB.row_capacity(int(total_rows))
    got = TB.expand_row_table(table, total_rows, r_cap)
    assert_same_table(got, spec(table, total_rows, r_cap))
    rows = TE.expand_rows_plain(table, total_rows, r_cap)
    live = torch.arange(r_cap) < total_rows
    x0, span = rows.ints[TE.ROW_X0], rows.ints[TE.ROW_SPANX]
    ints = got[0].ints
    whole = live & (ints[TE.TAB_X0] == x0) & (ints[TE.TAB_CNT] == span)
    inside = live & (ints[TE.TAB_X0] >= x0) & (
        ints[TE.TAB_X0] + ints[TE.TAB_CNT] <= x0 + span)
    assert int(whole.sum()) >= 32 and bool(inside[live].all())


def _mirror_row_tile_span(tx0_bbox, row, span_x, ry, cx, cy, ca, cb, cc):
    """csrc/expand.cu's row_tile_span in numpy float32, operation for
    operation: each op rounded once, clamp_min(x, lo) = (x < lo ? lo :
    x), maximum/minimum NaN if either side is, clamp = minimum(maximum(x,
    lo), hi), float -> int32 0 for NaN (the clamps keep every other value
    inside the bbox)."""
    f = np.float32

    def clamp_min(x, lo):
        return np.where(x < f(lo), f(lo), x).astype(f)

    def clamp(x, lo, hi):
        return np.minimum(np.maximum(x, lo), hi)

    def width(k, dy):
        return k * np.sqrt(clamp_min(ry * ry - dy * dy, 0.0))

    with np.errstate(all="ignore"):
        a_safe = clamp_min(ca, 1e-12)
        beta = cb / a_safe
        d = clamp_min(ca * cc - cb * cb, 0.0)
        k = np.sqrt(d) / a_safe
        dyg = cb * ry / clamp_min(np.sqrt(clamp_min(ca * cc, 0.0)), 1e-12)
        y_px = row * f(16)
        d_lo = clamp(y_px - cy, -ry, ry)
        d_hi = clamp(y_px + f(16) - cy, -ry, ry)
        c_max = clamp(-dyg, d_lo, d_hi)
        c_min = clamp(dyg, d_lo, d_hi)
        nb = -beta
        w_lo, w_hi = width(k, d_lo), width(k, d_hi)
        xmax = np.maximum(np.maximum(nb * d_lo + w_lo, nb * d_hi + w_hi),
                          nb * c_max + width(k, c_max))
        xmin = np.minimum(np.minimum(nb * d_lo - w_lo, nb * d_hi - w_hi),
                          nb * c_min - width(k, c_min))
        lo = np.floor((cx + xmin - f(0.05)) / f(16))
        hi = np.floor((cx + xmax + f(0.05)) / f(16)) + f(1)
        lo = clamp(lo, tx0_bbox, tx0_bbox + span_x - f(1))
        hi = clamp(hi, lo + f(1), tx0_bbox + span_x)
        cnt = hi - lo

    def to_int(x):
        return np.where(np.isnan(x), f(0), x).astype(np.int32)

    return to_int(lo), to_int(cnt)


def test_kernel_operations_round_as_row_tile_span():
    """The kernel's float32 operations, mirrored in numpy, equal torch's
    _row_tile_span bit for bit on every row of the adversarial table, the
    bicycle slab's rows and rows whose k overflows (NaN widths)."""
    dev = torch.device("cpu")
    streams = []
    b = bicycle_inputs(4_000, dev)
    for table, total_rows in (adversarial_table(dev),
                              (b["table"], b["total_rows"])):
        r_cap = TB.row_capacity(int(total_rows))
        streams.append(TE.expand_rows_plain(table, total_rows, r_cap))
    ints = torch.cat([s.ints for s in streams], dim=1)
    attrs = torch.cat([s.attrs for s in streams], dim=1)
    # (tx0_bbox, row, span_x, ry, cx, cy, ca, cb, cc): ca cc - cb^2 = inf
    # - inf, beta = inf times d_lo = 0 (both NaN, so an empty row at 0), an
    # infinite centre, a huge ry.
    nan_rows = torch.tensor([
        [3.0, 2.0, 4.0, 10.0, 50.0, 40.0, 1e30, 1e30, 1e30],
        [3.0, 2.0, 4.0, 10.0, 50.0, 32.0, 1e-13, 1e30, 1.0],
        [3.0, 2.0, 4.0, 10.0, float("inf"), 32.0, 0.5, 0.0, 0.5],
        [5.0, 8.0, 2.0, 1e30, 50.0, 60.0, 1e-12, 1e-30, 1e-3],
    ]).T
    args = [ints[TE.ROW_X0].float(), ints[TE.ROW_ROW].float(),
            ints[TE.ROW_SPANX].float(), attrs[9], *attrs[:5]]
    args = [torch.cat([a, r]) for a, r in zip(args, nan_rows)]
    tx0, cnt = TB._row_tile_span(*args)
    m_tx0, m_cnt = _mirror_row_tile_span(*(a.numpy() for a in args))
    np.testing.assert_array_equal(tx0.numpy(), m_tx0)
    np.testing.assert_array_equal(cnt.numpy(), m_cnt)
    assert not tx0[-4:-2].any() and not cnt[-4:-2].any()
    assert bool((cnt[:-4] >= 1).all()) and bool((cnt[-2:] >= 1).all())


def test_kernel_constants_are_binning_s():
    """csrc/expand.cu's tile size and trim epsilon are ops/binning.py's,
    as float32, and the attribute rows it reads are gaussian_table's."""
    src = (ROOT / "wgpu_3dgs_core_tpu_torch" / "csrc"
           / "expand.cu").read_text()

    def const(name):
        return float(re.search(rf"{name} = ([-0-9.e]+)f;", src).group(1))

    assert np.float32(const("kTileSize")) == np.float32(TB.TILE_SIZE)
    assert np.float32(const("kRowTrimEps")) == np.float32(TB.ROW_TRIM_EPS)
    assert [int(re.search(rf"kAttr{c} = (\d+);", src).group(1))
            for c in "XYABC"] == [0, 1, 2, 3, 4]


def test_cuda_route_fills_the_offsets_and_total(monkeypatch):
    """The CUDA route with on_cpu patched and the launch stood in for by
    what the kernel writes (every row but the offsets, left as garbage):
    one launch over r_cap slots, then the offsets and the total equal the
    spec's, no plain fallback."""
    table, total_rows = adversarial_table(torch.device("cpu"))
    r_cap = TB.row_capacity(int(total_rows)) + 512
    want = spec(table, total_rows, r_cap)
    calls = []

    def launch(tab, attr, n, a, total, cap, out_i, out_f, *, work, device):
        calls.append((n, a, cap, work, device.type))
        ints = want[0].ints.clone()
        ints[TE.TAB_OFF] = -12345
        for dst, src in ((out_i, ints), (out_f, want[0].attrs)):
            ctypes.memmove(dst, src.data_ptr(), src.numel() * 4)

    monkeypatch.setattr(TB, "on_cpu", lambda *t: False)
    monkeypatch.setattr(TB.EXPAND_ROW_TABLE, "launch", launch)
    monkeypatch.setattr(TB, "expand_rows_plain", None)
    monkeypatch.setattr(TB, "row_table", None)
    got = TB.expand_row_table(table, total_rows, r_cap)
    assert calls == [(table.ints.shape[1], 10, r_cap, r_cap, "cpu")]
    assert_same_table(got, want)


def test_bin_rasterize_counts_rows_and_row_capacity():
    """BinRasterize's forward counts ``rows``, the live row count (not
    clamped to the capacity), and ``row_capacity``, the row stream's
    capacity, beside the fragments and their capacity."""
    b = bicycle_inputs(4_000, torch.device("cpu"))
    rows, r_cap = int(b["total_rows"]), b["r_cap"]
    xy, extent, depth, mask, cols, tx, ty = b["binning"]
    for max_rows in (r_cap, 512):
        with tpf.counting() as rec, torch.no_grad():
            _, _, overflow = R.BinRasterize.apply(
                cols, xy, extent, depth, mask, tx, ty, 1 << 15,
                (0.0, 0.0, 0.0), 9.0, 0, 1.0, max_rows)
        sums, calls = rec.totals()
        assert sums["rows"] == rows and calls["rows"] == 1
        assert sums["row_capacity"] == TB.row_capacity(max_rows)
        assert calls["row_capacity"] == calls["fragments"] == 1
        assert bool(overflow) == (rows > TB.row_capacity(max_rows))
    assert rows > 512


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_equals_the_composition_at_6_1m(cuda):
    """The bicycle-6m scene (6.1M gaussians) from the view traffic's
    first camera: the kernel's table equals the composition's on the card
    (what the render path ran before) and on the CPU (the spec), ints and
    attributes bit for bit; bin_splats_attrs's stream, fragments and gid
    equal those of K1's row stream + row_table + K2 + the tile sort, the
    gather and tile_local_stream (the render path before), and so do
    K3's tiles."""
    b = bicycle_inputs(6_100_000, cuda)
    table, total_rows, r_cap = b["table"], b["total_rows"], b["r_cap"]
    got = TB.expand_row_table(table, total_rows, r_cap)
    on_card = TB.row_table(TE.expand_rows(table, total_rows, r_cap),
                           total_rows)
    assert_same_table(got, on_card)
    cpu = TE.SegmentTable(table.ints.cpu(), table.attrs.cpu())
    assert_same_table(got, spec(cpu, total_rows.cpu(), r_cap))
    assert 5_000_000 < int(total_rows) <= r_cap

    tx, ty = b["binning"][-2:]
    f_cap = -(-b["max_fragments"] // TB.CHUNK) * TB.CHUNK
    stream, frags, _ = TB.bin_splats_attrs(
        *b["binning"], f_cap, max_rows=b["max_rows"])
    tile, _, fetched = TE.expand_fragments_with_attrs(
        on_card[0], on_card[1], f_cap, tx, tx * ty)
    tile_sorted, perm = torch.sort(tile, stable=True)
    before = fetched[:, perm]
    want = TB.tile_local_stream(before, tile_sorted, tx)
    assert not bool(stream.overflow)
    assert torch.equal(stream.tile_id, tile_sorted)
    assert torch.equal(frags.view(torch.int32), want.view(torch.int32))
    assert torch.equal(stream.gauss_id, before[9].to(torch.int32))
    sched = TB.pad_schedule(stream, TB.padded_capacity(f_cap, tx * ty, 1.0))
    tiles = [TR.rasterize_tiles_fwd(
        f, stream.tile_start, sched.draw_len, (0.0, 0.0, 0.0), 9.0, 0)
        for f in (frags, want)]
    assert torch.equal(tiles[0].view(torch.int32), tiles[1].view(torch.int32))


@pytest.mark.cuda
def test_kernel_equals_the_composition_on_hard_rows(cuda):
    """The adversarial table on the card, whole and truncated by the row
    capacity, the same with non-finite gaussians, and an empty table: bit
    for bit the CPU composition and the card's; the non-finite gaussians'
    NaN rows are empty."""
    table, total_rows = adversarial_table(cuda)
    bad, bad_rows = adversarial_table(cuda, non_finite=True)
    empty = TE.SegmentTable(
        torch.zeros((TE.TAB_ROWS, 0), dtype=torch.int32, device=cuda),
        torch.zeros((10, 0), device=cuda))
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    for tab, tot, r_cap in ((table, total_rows,
                             TB.row_capacity(int(total_rows)) + 512),
                            (table, total_rows, 512),
                            (bad, bad_rows, TB.row_capacity(int(bad_rows))),
                            (empty, zero, 1024)):
        got = TB.expand_row_table(tab, tot, r_cap)
        cpu = TE.SegmentTable(tab.ints.cpu(), tab.attrs.cpu())
        assert_same_table(got, spec(cpu, tot.cpu(), r_cap))
        assert_same_table(got, spec(tab, tot, r_cap))
    got, _ = TB.expand_row_table(bad, bad_rows,
                                 TB.row_capacity(int(bad_rows)))
    assert int((got.ints[TE.TAB_CNT, :int(bad_rows)] == 0).sum()) == 10
