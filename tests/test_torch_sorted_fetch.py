"""K14, the sorted fetch (``ops/binning.py::sorted_fetch``), and K2's
record form (``ops/expand.py::expand_fragment_records``): the binning's
fragment side from K2 to the rasterizer's tile-local stream.

K2's record form writes each slot's 9 blend attributes and its gid's bits
as one 48-B record; K14 reads the records through the tile sort's
permutation and writes the tile-local [9, F] stream and the int32 gid.
Their spec is what the render path computed before: K2's [A + 1, F]
form, the [10, F] gather through the permutation, ``tile_local_stream``
and the gid row's cast. The CPU cases hold the plain versions against
that composition bit for bit (padding past the live count, overflow,
streams with NaN, infinite, -0 and denormal attributes, empty tiles, the
last tile column and row), the record form against the row form
transposed (hard and non-finite rows, an empty table), ``render``'s
images and gradients against the render path before in SPLAT, ELLIPSE
and POINT mode, and the card routes with the launches stood in for. The
cases marked ``cuda`` hold the kernels bit for bit against their plain
versions on the card (6.1M gaussians, the hard streams, two launches
alike) and the ``sorted_fetch`` counter of a frame and a step, and skip
without one. No JAX: run on the card with ``--noconftest``.
"""

import ctypes
import json

import numpy as np
import pytest
import torch

from benchmark import scene as bench_scene
from wgpu_3dgs_core_tpu_torch.ops import binning as TB
from wgpu_3dgs_core_tpu_torch.ops import expand as TE
from wgpu_3dgs_core_tpu_torch.ops.transforms import cov3d_from_rot_scale
from wgpu_3dgs_core_tpu_torch.render import renderer as R
from wgpu_3dgs_core_tpu_torch.utils import profiling as tpf

from .test_torch_row_table import (
    CONFIG,
    SEED,
    VIEW,
    adversarial_table,
    bicycle_inputs,
)
from .torch_parity import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def before(records, perm, tile_sorted, tiles_x):
    """The render path before K14, from K2's [A + 1, F] form (here the
    records as that form): the [10, F] gather, tile_local_stream and the
    gid row's cast."""
    fetched = torch.cat([records[:, :TE.RECORD_ATTRS].T,
                         records[:, TE.RECORD_GID].view(torch.int32)
                         .float()[None]])
    attrs_sorted = fetched[:, perm]
    return (TB.tile_local_stream(attrs_sorted, tile_sorted, tiles_x),
            attrs_sorted[TE.RECORD_ATTRS].to(torch.int32))


def assert_same(got, want):
    """(frags, gid) bit for bit, in the kernel's layouts."""
    (gf, gg), (wf, wg) = got, want
    assert gf.dtype == torch.float32 and gf.is_contiguous()
    assert gg.dtype == torch.int32 and gg.is_contiguous()
    assert gf.shape == wf.shape and gg.shape == wg.shape
    assert torch.equal(bits(gf).cpu(), bits(wf).cpu())
    assert torch.equal(gg.cpu(), wg.cpu())


def hard_streams(device):
    """K14's inputs the fetch finds hard, on a 7 x 5 grid: (name,
    records, perm, tile_sorted, tiles_x, t_total). Live slots first in
    emission order, on a few tiles among them the first, the last column,
    the first of the last row and the last tile, most tiles empty; their
    records drawn from every bit pattern (NaN of several payloads, +-inf,
    -0, denormals) with gids below 2^24; padding slots (tile t_total)
    with zero records, as K2 writes them."""
    rng = np.random.default_rng(22)
    tx, ty = 7, 5
    t_total = tx * ty
    on = np.array([0, tx - 1, t_total - tx, t_total - 1, 9, 17])
    special = np.array([0x7FC00000, 0x7FC00001, 0xFFFFFFFF, 0x7F800001,
                        0x7F800000, 0xFF800000, 0x80000000, 0x00000001,
                        0x807FFFFF, 0x3F800000], np.uint32)
    out = []
    for name, f, live in (("mixed", 1000, 700), ("all padding", 300, 0),
                          ("no padding", 513, 513), ("one slot", 1, 1)):
        tile = np.full(f, t_total, np.int32)
        tile[:live] = rng.choice(on, live)
        raw = rng.integers(0, 1 << 32, (f, TE.RECORD_WIDTH), np.uint64)
        raw = raw.astype(np.uint32)
        pick = rng.random((f, TE.RECORD_WIDTH)) < 0.3
        raw[pick] = rng.choice(special, int(pick.sum()))
        raw[:, TE.RECORD_GID] = rng.integers(0, 1 << 24, f)
        raw[:, TE.RECORD_GID + 1:] = 0
        raw[live:] = 0
        records = torch.from_numpy(raw.view(np.int32)).view(torch.float32)
        tile_t = torch.from_numpy(tile)
        tile_sorted, perm = torch.sort(tile_t, stable=True)
        out.append((name, records.to(device), perm.to(device),
                    tile_sorted.to(device), tx, t_total))
    return out


def fragment_side(b, f_cap):
    """K2's row and record forms on the per-row table of bicycle_inputs
    ``b``, and the tile sort: (records, tile, perm, tile_sorted, tiles_x,
    t_total, fetched, total, the per-row table)."""
    tx, ty = b["binning"][-2:]
    rtab, total = TB.expand_row_table(b["table"], b["total_rows"],
                                      b["r_cap"])
    tile, records = TE.expand_fragment_records(rtab, total, f_cap, tx,
                                               tx * ty)
    tile_rows, _, fetched = TE.expand_fragments_with_attrs(
        rtab, total, f_cap, tx, tx * ty)
    assert torch.equal(tile, tile_rows)
    tile_sorted, perm = torch.sort(tile, stable=True)
    return (records, tile, perm, tile_sorted, tx, tx * ty, fetched, total,
            rtab)


@pytest.mark.parametrize("case", ["padding", "overflow"])
def test_plain_is_the_composition_on_the_bicycle_slab(case):
    """K2's record form and K14's plain versions, from the bicycle-6m slab
    at 20,000 gaussians, give the render path's stream before them bit
    for bit: with room to spare (padding slots past the live count) and
    with a capacity below the live count (overflow)."""
    b = bicycle_inputs(20_000, CPU)
    f_cap = (b["max_fragments"] if case == "padding"
             else b["max_fragments"] // 3)
    records, _, perm, tile_sorted, tx, t_total, fetched, total, _ = (
        fragment_side(b, f_cap))
    assert (int(total) < f_cap) == (case == "padding")
    got = TB.sorted_fetch(records, perm, tile_sorted, tx, t_total)
    attrs_sorted = fetched[:, perm]
    assert_same(got, (TB.tile_local_stream(attrs_sorted, tile_sorted, tx),
                      attrs_sorted[TE.RECORD_ATTRS].to(torch.int32)))
    live = min(int(total), f_cap)
    assert int((tile_sorted == t_total).sum()) == f_cap - live
    if case == "padding":  # the origin of tile t_total, zeros, gid 0
        frags, gid = got
        pad = frags[:, live:]
        assert bool((pad[0] == 0).all())
        assert bool((pad[1] == -16.0 * (t_total // tx)).all())
        assert not pad[2:].any() and not gid[live:].any()


def test_plain_is_the_composition_on_hard_streams():
    """K14's plain version on the hard streams: bit for bit the render
    path's composition, NaN payloads included."""
    for _, records, perm, tile_sorted, tx, t_total in hard_streams(CPU):
        got = TB.sorted_fetch(records, perm, tile_sorted, tx, t_total)
        assert_same(got, before(records, perm, tile_sorted, tx))


def test_record_form_is_the_row_form_transposed():
    """K2's record form against its [A + 1, F] form on the adversarial
    rows (whole, truncated, with non-finite gaussians) and an empty
    table: the same tiles, the attribute rows transposed, the gid's int32
    bits, zeros after it, bit for bit."""
    cases = []
    for non_finite in (False, True):
        table, total_rows = adversarial_table(CPU, non_finite=non_finite)
        r_cap = TB.row_capacity(int(total_rows))
        rtab, total = TB.expand_row_table(table, total_rows, r_cap)
        cases += [(rtab, total, int(total) + 333), (rtab, total, 256)]
    empty = TE.SegmentTable(torch.zeros((TE.TAB_ROWS, 0), dtype=torch.int32),
                            torch.zeros((TE.RECORD_ATTRS, 0)))
    cases.append((empty, torch.zeros((), dtype=torch.int32), 100))
    tx, ty = 40, 30
    for rtab, total, f_cap in cases:
        tile, rec = TE.expand_fragment_records(rtab, total, f_cap, tx,
                                               tx * ty)
        want_tile, gid, attrs = TE.expand_fragments_with_attrs(
            rtab, total, f_cap, tx, tx * ty)
        assert rec.shape == (f_cap, TE.RECORD_WIDTH) and rec.is_contiguous()
        assert torch.equal(tile, want_tile)
        assert torch.equal(bits(rec[:, :TE.RECORD_ATTRS]),
                           bits(attrs[:TE.RECORD_ATTRS].T))
        assert torch.equal(bits(rec[:, TE.RECORD_GID]), gid)
        assert torch.equal(gid, attrs[TE.RECORD_GID].to(torch.int32))
        assert not rec[:, TE.RECORD_GID + 1:].any()
    with pytest.raises(ValueError, match="record form"):
        TE.expand_fragment_records(TE.SegmentTable(rtab.ints, rtab.attrs[:8]),
                                   total, 64, tx, tx * ty)


def bin_splats_attrs_before(xy, extent, depth, mask, attr_cols, tiles_x,
                            tiles_y, max_fragments, max_rows=None,
                            cutoff_sq=9.0, opacity_cull=True):
    """The binning as the render path ran it before K14: K2's [A + 1, F]
    form, the tile sort, the [10, F] gather, the gid row's cast and
    tile_local_stream; the same return as bin_splats_attrs."""
    t_total = tiles_x * tiles_y
    table, total_rows = TB.gaussian_table(
        xy, extent, depth, mask, attr_cols, tiles_x, tiles_y, cutoff_sq,
        opacity_cull)
    r_cap = TB.row_capacity(max_fragments if max_rows is None else max_rows)
    rtab, total = TB.expand_row_table(table, total_rows, r_cap)
    tile, _, fetched = TE.expand_fragments_with_attrs(
        rtab, total, max_fragments, tiles_x, t_total)
    tile_sorted, perm = torch.sort(tile, stable=True)
    attrs_sorted = fetched[:, perm]
    ids = torch.arange(t_total, dtype=torch.int32)
    stream = TB.FragmentStream(
        gauss_id=attrs_sorted[attr_cols.shape[0]].to(torch.int32),
        tile_id=tile_sorted,
        num_fragments=torch.clamp_max(total, max_fragments),
        overflow=(total_rows > r_cap) | (total > max_fragments),
        tile_start=torch.searchsorted(tile_sorted, ids, out_int32=True),
        tile_end=torch.searchsorted(tile_sorted, ids, right=True,
                                    out_int32=True),
    )
    return (stream, TB.tile_local_stream(attrs_sorted, tile_sorted, tiles_x),
            table)


@pytest.mark.parametrize("mode", [R.GaussianDisplayMode.SPLAT,
                                  R.GaussianDisplayMode.ELLIPSE,
                                  R.GaussianDisplayMode.POINT],
                         ids=lambda m: m.name)
def test_render_is_unchanged_on_cpu(mode, monkeypatch):
    """render on the bicycle slab at 3,000 gaussians, 160x120, SH degree
    3: its image, transmittance, overflow flag and the gradients of every
    input equal those of the render path before K14, bit for bit."""
    cfg = dict(json.loads(CONFIG.read_text()), gaussians=3_000, width=160,
               height=120)
    traffic = json.loads(VIEW.read_text())
    s = bench_scene.draw_scene(cfg, SEED, CPU)
    cam = bench_scene.port_camera(bench_scene.orbit_view(cfg, traffic, 5.0,
                                                         3.0))
    leaves = [s["means"], cov3d_from_rot_scale(s["quats"], s["scales"]),
              s["colour"], s["opacity"], s["sh"]]
    caps = R.measure_capacities(leaves[0], leaves[1], leaves[3], cam,
                                display_mode=mode)

    def run():
        x = [t.detach().clone().requires_grad_(True) for t in leaves]
        res = R.render(*x[:4], cam, sh=x[4], sh_deg=3,
                       background=(0.1, 0.2, 0.3), max_fragments=caps[0],
                       max_rows=caps[1], display_mode=mode)
        loss = (res.image ** 2).sum() + res.transmittance.sum()
        return res, torch.autograd.grad(loss, x)

    (res, grads) = run()
    monkeypatch.setattr(R, "bin_splats_attrs", bin_splats_attrs_before)
    (res0, grads0) = run()
    assert not bool(res.overflow) and not bool(res0.overflow)
    for got, want in zip((res.image, res.transmittance, *grads),
                         (res0.image, res0.transmittance, *grads0)):
        assert torch.equal(bits(got), bits(want))
    assert float(res.image.detach().abs().max()) > 0


def test_card_routes_launch_once_and_count(monkeypatch):
    """The card routes of K2's record form and K14 with on_cpu patched and
    each launch stood in for by its plain version's writes: one launch
    each over the whole capacity, no plain fallback, the arguments
    checked, and one ``sorted_fetch`` count a call in the open counting
    session."""
    _, records, perm, tile_sorted, tx, t_total = hard_streams(CPU)[0]
    want = before(records, perm, tile_sorted, tx)
    table, total_rows = adversarial_table(CPU)
    rtab, total = TB.expand_row_table(table, total_rows,
                                      TB.row_capacity(int(total_rows)))
    want_rec = TE.expand_fragment_records_plain(rtab, total, 4096, 40, 1200)
    calls = []

    def fetch(rec, p, t, f, tiles_x, tt, frags, gid, *, work, device):
        calls.append(("sorted_fetch", f, tiles_x, tt, work))
        for dst, src in ((frags, want[0]), (gid, want[1])):
            ctypes.memmove(dst, src.data_ptr(), src.numel() * 4)

    def expand(tab, attr, n, tot, cap, tiles_x, tt, out_t, out_r, *, work,
               device):
        calls.append(("expand_fragment_records", n, cap, tiles_x, tt, work))
        for dst, src in ((out_t, want_rec[0]), (out_r, want_rec[1])):
            ctypes.memmove(dst, src.data_ptr(), src.numel() * 4)

    monkeypatch.setattr(TB, "on_cpu", lambda *t: False)
    monkeypatch.setattr(TE, "on_cpu", lambda *t: False)
    monkeypatch.setattr(TB.SORTED_FETCH, "launch", fetch)
    monkeypatch.setattr(TE.EXPAND_RECORDS, "launch", expand)
    monkeypatch.setattr(TB, "sorted_fetch_plain", None)
    monkeypatch.setattr(TE, "expand_fragment_records_plain", None)
    f = perm.shape[0]
    with tpf.counting() as rec:
        got = TB.sorted_fetch(records, perm, tile_sorted, tx, t_total)
        tile, recs = TE.expand_fragment_records(rtab, total, 4096, 40, 1200)
    assert calls == [("sorted_fetch", f, tx, t_total, f),
                     ("expand_fragment_records", rtab.ints.shape[1], 4096,
                      40, 1200, 4096)]
    assert_same(got, want)
    assert torch.equal(tile, want_rec[0])
    assert torch.equal(bits(recs), bits(want_rec[1]))
    assert rec.totals() == ({"sorted_fetch": 1}, {"sorted_fetch": 1})
    with pytest.raises(TypeError, match="perm"):
        TB.sorted_fetch(records, perm.int(), tile_sorted, tx, t_total)
    with pytest.raises(ValueError, match="records"):
        TB.sorted_fetch(records[:, :10].contiguous(), perm, tile_sorted, tx,
                        t_total)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_equal_plain_at_6_1m(cuda):
    """The bicycle-6m scene (6.1M gaussians) from the view traffic's
    first camera: K2's record form and K14 bit for bit their plain
    versions on the card and the render path's composition before them,
    padding slots included; two launches of each alike."""
    b = bicycle_inputs(6_100_000, cuda)
    f_cap = -(-b["max_fragments"] // TB.CHUNK) * TB.CHUNK
    records, tile, perm, tile_sorted, tx, t_total, fetched, total, rtab = (
        fragment_side(b, f_cap))
    want_tile, want_rec = TE.expand_fragment_records_plain(
        rtab, total, f_cap, tx, t_total)
    assert torch.equal(tile, want_tile)
    assert torch.equal(bits(records), bits(want_rec))
    again = TE.expand_fragment_records(rtab, total, f_cap, tx, t_total)
    assert torch.equal(bits(again[1]), bits(records))
    got = TB.sorted_fetch(records, perm, tile_sorted, tx, t_total)
    assert_same(got, TB.sorted_fetch_plain(records, perm, tile_sorted, tx,
                                           t_total))
    attrs_sorted = fetched[:, perm]
    assert_same(got, (TB.tile_local_stream(attrs_sorted, tile_sorted, tx),
                      attrs_sorted[TE.RECORD_ATTRS].to(torch.int32)))
    assert_same(TB.sorted_fetch(records, perm, tile_sorted, tx, t_total), got)
    live = int(total)
    assert 5_000_000 < live < f_cap
    assert bool((got[0][1, live:] == -16.0 * (t_total // tx)).all())


@pytest.mark.cuda
def test_kernels_equal_plain_on_hard_streams(cuda):
    """K14 on the hard streams and K2's record form on the adversarial
    rows (non-finite ones included) and an empty table: bit for bit
    their plain versions on the card, two launches alike; the copied
    rows and the gid also bit for bit the CPU's."""
    for _, records, perm, tile_sorted, tx, t_total in hard_streams(cuda):
        got = TB.sorted_fetch(records, perm, tile_sorted, tx, t_total)
        assert_same(got, TB.sorted_fetch_plain(records, perm, tile_sorted,
                                               tx, t_total))
        assert_same(TB.sorted_fetch(records, perm, tile_sorted, tx,
                                    t_total), got)
        cpu = before(records.cpu(), perm.cpu(), tile_sorted.cpu(), tx)
        assert torch.equal(bits(got[0][2:]).cpu(), bits(cpu[0][2:]))
        assert torch.equal(got[1].cpu(), cpu[1])
    for non_finite in (False, True):
        table, total_rows = adversarial_table(cuda, non_finite=non_finite)
        rtab, total = TB.expand_row_table(table, total_rows,
                                          TB.row_capacity(int(total_rows)))
        for f_cap in (int(total) + 333, 256):
            got = TE.expand_fragment_records(rtab, total, f_cap, 40, 1200)
            want = TE.expand_fragment_records_plain(rtab, total, f_cap, 40,
                                                    1200)
            assert torch.equal(got[0], want[0])
            assert torch.equal(bits(got[1]), bits(want[1]))
    empty = TE.SegmentTable(
        torch.zeros((TE.TAB_ROWS, 0), dtype=torch.int32, device=cuda),
        torch.zeros((TE.RECORD_ATTRS, 0), device=cuda))
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    tile, rec = TE.expand_fragment_records(empty, zero, 100, 40, 1200)
    assert bool((tile == 1200).all()) and not rec.any()


@pytest.mark.cuda
def test_sorted_fetch_counts_once_a_frame_and_a_step(cuda):
    """A frame (render) and a step (render, then its backward) each count
    one ``sorted_fetch`` call, and launch K14 once."""
    b = bicycle_inputs(20_000, cuda)
    xy, extent, depth, mask, cols, tx, ty = b["binning"]
    f_cap = -(-b["max_fragments"] // TB.CHUNK) * TB.CHUNK
    cols = cols.detach().clone().requires_grad_(True)
    for backward in (False, True):
        TB.SORTED_FETCH.launches = 0
        with tpf.counting() as rec:
            tiles, _, _ = R.BinRasterize.apply(
                cols, xy, extent, depth, mask, tx, ty, f_cap,
                (0.0, 0.0, 0.0), 9.0, 0, 1.0, b["max_rows"])
            if backward:
                tiles.sum().backward()
        assert rec.totals()[1]["sorted_fetch"] == 1
        assert TB.SORTED_FETCH.launches == 1
