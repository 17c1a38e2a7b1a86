"""The four synthetic measurement tools' stages on the card (marker
``cuda``): ``tools/bench_sort_shapes.py``, ``bench_irregular_ops.py``,
``bench_reorder.py`` and ``bench_reorder2.py`` of the port, each stage on
CUDA tensors against the same stage on CPU tensors of the same draws, by
``torch_parity.assert_same_stage``: bit for bit, an unstable sort by its
keys and sorted (key, payload) rows, the sums (``index_add_``'s atomics,
``segment_reduce``, ``cumsum``) within 1e-5 of the largest |value|.

These need a CUDA card, and skip without one. On a machine with a card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_tools.py``
(tests/conftest.py imports jax). chip_smoke.py's phase 24 reads the same
stages at the JAX tools' sizes.
"""

import pytest
import torch

from wgpu_3dgs_core_tpu_torch.tools import (
    bench_irregular_ops,
    bench_reorder,
    bench_reorder2,
    bench_sort_shapes,
)

from .torch_parity import assert_same_stage

pytestmark = pytest.mark.cuda

F, N, T, K = 65_536, 16_384, 512, 128
# Each tool: its module, its draws, and its stages on its inputs.
TOOLS = (
    (bench_sort_shapes, lambda: bench_sort_shapes.draw(F, F + 4_000,
                                                       F + 1_000, N),
     bench_sort_shapes.stages),
    (bench_irregular_ops, lambda: bench_irregular_ops.draw(F, N, T),
     bench_irregular_ops.stages),
    (bench_reorder, lambda: bench_reorder.draw(F, N), bench_reorder.stages),
    (bench_reorder2, lambda: bench_reorder2.draw(F, N, K),
     lambda x: bench_reorder2.stages(x, K)),
)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_tool_stages_on_card_match_cpu(cuda):
    for module, draw, stages in TOOLS:
        arrays = draw()
        on_cpu = stages(module.inputs(arrays, "cpu"))
        on_card = stages(module.inputs(arrays, cuda))
        for name, fn in on_card.items():
            got = fn()
            torch.cuda.synchronize(cuda)
            assert_same_stage(got, on_cpu[name](), name)
