"""The host side of the redesigned K7 and K8, on the CPU.

K7 (``ops/expand.py::expand_fragments``) gives each block a fixed stretch
of the merge of a segment table's row offsets with the slots; its mirror
``merge_path_partition_plain`` is held to the merge's definition (a sort
of offsets and slots) and to ``searchsorted`` on the tables
``tools/expand_tables.py`` makes hard, and each block's window of rows is
shown to hold every owner of its slots. K8's tiled map
(``csrc/bundle.cuh``) runs a block per tile of ``ops/kernel_bundle.py::
tile_plan`` items: the tiles of the unpack's 12 layouts, map_add and
3-byte rows let four blocks share an SM. K8's lean dispatch re-checks
only what can change, and still raises every error of a full validation.
The kernels run on the card in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu_torch as T
import wgpu_3dgs_core_tpu_torch.errors as TE
from wgpu_3dgs_core_tpu_torch.ops import expand as ex
from wgpu_3dgs_core_tpu_torch.ops import kernel_bundle as kb
from wgpu_3dgs_core_tpu_torch.ops import unpack_bundle as ub
from wgpu_3dgs_core_tpu_torch.tools.expand_tables import (
    HARD_TABLES,
    hard_tables,
)

from .torch_parity import one_torch_thread  # noqa: F401

MAP_ADD = T.BundleKernel(cuda="""
__device__ void map_add(const float* a, const float* b, float* out) {
  out[0] = __fadd_rn(a[0], b[0]);
}""", entry="map_add", plain=lambda a, b, out: out.copy_(a + b))


def _merge_rows(off: torch.Tensor, cap: int, d: torch.Tensor):
    """Rows among the first d elements of the merge, by its definition: a
    stable sort of the rows keyed 2 off and the slots keyed 2 s + 1 (a row
    before a slot when off <= slot)."""
    n = off.shape[0]
    keys = torch.cat([2 * off.long(), 2 * torch.arange(cap) + 1])
    order = torch.sort(keys, stable=True).indices
    taken = torch.cat([torch.zeros(1, dtype=torch.long),
                       torch.cumsum((order < n).long(), 0)])
    return taken[d]


@pytest.mark.parametrize("name", HARD_TABLES)
def test_merge_path_partition(name):
    """Each block starts where the merge puts it: rows taken equal the
    sorted merge's, and lie between the rows with offset below and at the
    block's first slot (``searchsorted``); blocks take MERGE_ITEMS steps,
    the last ends at (cap, n); and the rows a block loads, from the one
    before its start to its end, hold the owner of each of its slots."""
    table, total, cap = hard_tables()[name][:3]
    off = table.ints[ex.TAB_OFF]
    n = off.shape[0]
    if name == "ragged_cap":
        assert cap % ex.MERGE_ITEMS and (n + cap) % ex.MERGE_ITEMS
    if name == "full":
        assert cap == int(total)
    slot, row = ex.merge_path_partition_plain(off, cap)
    d = slot + row
    blocks = slot.shape[0] - 1
    assert blocks == -(-(n + cap) // ex.MERGE_ITEMS)
    assert torch.equal(d[:-1], torch.arange(blocks) * ex.MERGE_ITEMS)
    assert (int(slot[-1]), int(row[-1])) == (cap, n)
    assert bool((slot.diff() >= 0).all() and (row.diff() >= 0).all())
    assert torch.equal(row, _merge_rows(off, cap, d))
    below = torch.searchsorted(off, slot.int() - 1, right=True)
    at = torch.searchsorted(off, slot.int(), right=True)
    assert bool(((below <= row) & (row <= at)).all())
    slots = torch.arange(min(int(total), cap), dtype=torch.int32)
    owner = torch.clamp(torch.searchsorted(off, slots, right=True) - 1, 0,
                        max(n - 1, 0))
    for b in range(blocks):
        j0, j1 = int(slot[b]), int(slot[b + 1])
        r0, r1 = max(int(row[b]) - 1, 0), int(row[b + 1])
        s = slots[j0:j1]
        local = torch.searchsorted(off[r0:r1], s, right=True) - 1
        assert torch.equal(torch.clamp(local, min=0) + r0, owner[j0:j1])


def test_merge_path_partition_without_rows_or_room():
    """An empty table's blocks take slots alone; when the slots overflow
    the capacity (total > cap), the rows whose offsets pass it follow the
    last slot, and every block's window still holds its slots' owners."""
    slot, row = ex.merge_path_partition_plain(
        torch.zeros(0, dtype=torch.int32), 5_000)
    assert torch.equal(row, torch.zeros(4, dtype=torch.long))
    assert slot.tolist() == [0, 2048, 4096, 5000]
    counts = torch.from_numpy(np.random.default_rng(7).integers(0, 6, 3_000))
    off = (torch.cumsum(counts, 0) - counts).int()
    cap = int(counts.sum()) // 2
    slot, row = ex.merge_path_partition_plain(off, cap)
    assert torch.equal(row, _merge_rows(off, cap, slot + row))
    late = int((off >= cap).sum())  # rows past the capacity
    assert late > 0 and bool((row[slot < cap] <= off.shape[0] - late).all())
    owner = torch.searchsorted(off, torch.arange(cap, dtype=torch.int32),
                               right=True) - 1
    for b in range(slot.shape[0] - 1):
        r0, r1 = max(int(row[b]) - 1, 0), int(row[b + 1])
        got = owner[int(slot[b]):int(slot[b + 1])]
        assert bool(((got >= r0) & (got < r1)).all())


def test_tile_plan_of_the_core_path():
    """The unpack of each of the 12 layouts, map_add and 3-byte rows get a
    tile of a multiple of 16 items, at most ITEMS_PER_THREAD a thread,
    whose rows fit TILE_BYTES, so that four blocks share an SM."""
    soa = T.GaussianSoA(
        rot=np.tile(np.float32([0, 0, 0, 1]), (4, 1)),
        pos=np.zeros((4, 3), np.float32),
        color=np.zeros((4, 4), np.uint8),
        sh=np.zeros((4, 15, 3), np.float32),
        scale=np.ones((4, 3), np.float32))
    signatures = {"map_add": ([4, 4, 4], kb.DEFAULT_BLOCK_SIZE),
                  "3-byte rows": ([3, 12], 64)}
    for layout in T.ALL_LAYOUTS:
        res = ub.resources(T.GaussiansBuffer.new(soa, layout, "cpu"))
        rows = [t[0].numel() * t.element_size() for t in res]
        signatures[str(layout)] = (rows + [4 * w for w in ub.OUTPUT_WIDTHS],
                                   ub.BLOCK_SIZE)
    for name, (rows, block) in signatures.items():
        items = kb.tile_plan(rows, block)
        smem = kb.tile_smem(rows, items)
        assert items >= 16 and items % 16 == 0, name
        assert items <= kb.ITEMS_PER_THREAD * block, name
        assert items * sum(rows) <= kb.TILE_BYTES, name
        assert smem == items * sum(rows) + kb.BARRIER_BYTES, name
        # An SM's 233,472 bytes, less the runtime's 1,024 a block.
        assert 4 * (smem + 1_024) <= 233_472, name
    default = ub.resources(T.GaussiansBuffer.new(soa, T.GaussianLayout(),
                                                 "cpu"))
    assert sum(t[0].numel() * t.element_size() for t in default) == 224
    assert kb.tile_plan([12, 4, 180, 28, 16, 16, 180, 24], 128) == 112
    assert kb.tile_plan([4, 4, 4], 256) == 1024
    assert kb.tile_plan([3, 12], 64) == 256


def test_tile_plan_of_wide_rows():
    """Rows too wide for a tile of TILE_BYTES take 16 items while those
    fit a block's opt-in limit; wider still, the direct kernel."""
    for row, items in ((5_000, 16), (14_000, 16), (15_000, 0)):
        assert kb.tile_plan([row], 256) == items
        if items:
            assert kb.tile_smem([row], items) <= kb.SMEM_OPTIN
        else:
            assert kb.tile_smem([row], 16) > kb.SMEM_OPTIN


def _bundle(n, block=256):
    a = torch.arange(n, dtype=torch.float32)
    b = torch.ones(n)
    bundle = (T.KernelBundleBuilder()
              .resource_layout(T.ResourceGroupLayout("inputs", arity=2))
              .kernel(MAP_ADD).output(1).block_size(block).build([[a, b]]))
    return bundle, a, b


def test_owned_resources_with_a_new_row_count_raise():
    """After update_resources with tensors of another row count, a
    dispatch of the old count raises as a full validation does, and one
    of the new count runs."""
    n, m = 100, 60
    bundle, a, b = _bundle(n)
    assert torch.equal(bundle.dispatch(n)[:, 0], a + 1)
    bundle.update_resources([[a[:m].clone(), b[:m].clone()]])
    with pytest.raises(ValueError, match="dispatch count is 100"):
        bundle.dispatch(n)
    assert torch.equal(bundle.dispatch(m)[:, 0], a[:m] + 1)
    with pytest.raises(TE.KernelBundleResourceCountError):
        bundle.update_resources([[a]])
    uneven = _bundle(n)[0]
    uneven.update_resources([[a, b[:m]]])
    with pytest.raises(ValueError):
        uneven.dispatch(n)


def test_owned_resources_are_rechecked_each_call():
    """A dispatch sees an update in place, a tensor resized in place (its
    shape) and one re-pointed at new storage (its pointer); a non-
    contiguous or numpy resource takes the full validation each call."""
    n = 64
    bundle, a, b = _bundle(n)
    bundle.dispatch(n)
    a.add_(2.0)  # in place: same storage, same shape
    assert torch.equal(bundle.dispatch(n)[:, 0], a + 1)
    b.resize_(n // 2)
    with pytest.raises(ValueError):
        bundle.dispatch(n)
    b.set_(torch.full((n,), 3.0))
    assert torch.equal(bundle.dispatch(n)[:, 0], a + 3)
    wide = torch.arange(2 * n, dtype=torch.float32)
    bundle.update_resources([[wide[::2], np.ones(n, np.float32)]])
    assert torch.equal(bundle.dispatch(n)[:, 0], wide[::2] + 1)
    cube = torch.zeros((n, 1, 1))
    with pytest.raises(ValueError):
        bundle.dispatch(n, [[cube, cube]])
    with pytest.raises(TE.KernelBundleResourceCountError):
        bundle.dispatch(n, [[a]])
    free = (T.KernelBundleBuilder()
            .resource_layout(T.ResourceGroupLayout("inputs", arity=2))
            .kernel(MAP_ADD).output(1).build_without_resources())
    with pytest.raises(TE.KernelBundleResourceCountError):
        free.dispatch(n)


def test_cuda_route_passes_the_tile(monkeypatch):
    """On the CUDA route (``on_cpu`` patched to False, nvcc and the launch
    stubbed) the entry gets the count, the block, the signature's tile
    and each array's pointer and width; the tile is kept per row widths,
    the source built once, the one ``cuda_source`` gives."""
    builds, launches = [], []
    monkeypatch.setattr(kb, "on_cpu", lambda *t: False)
    monkeypatch.setattr(kb.cuda, "build_sources", lambda srcs: builds.append(
        srcs) or [kb.cuda.BuildInfo(None, 0.0, "")])
    monkeypatch.setattr(kb.cuda, "bundle_library", lambda path: None)
    monkeypatch.setattr(kb.cuda, "bind", lambda lib, sym, types: types)
    monkeypatch.setattr(kb.KERNEL_BUNDLE, "call",
                        lambda fn, lib, *args, **kw: launches.append(
                            (fn, args, kw["work"])))
    n = 1000
    bundle, a, b = _bundle(n, block=128)
    bundle.dispatch(n)
    x8 = torch.zeros((n, 8))
    bundle.dispatch(n, [[x8, x8]])
    assert len(builds) == 1
    (types, args, work), (_, args8, _) = launches
    assert len(types) == 3 + 2 * 3 and work == n
    assert args[:3] == (n, 128, kb.tile_plan([4, 4, 4], 128)) == (n, 128, 512)
    assert args[3:] == (a.data_ptr(), 1, b.data_ptr(), 1, args[7], 1)
    assert args8[2] == kb.tile_plan([32, 32, 4], 128) == 512
    src = builds[0][0]
    assert "gs::launch_map<gs_bundle_item>(count, block, tile, stream," in src
    assert "    int tile," in src.splitlines()
    assert bundle.cuda_source(n) == src and src.count("GS_EXPORT") == 1
