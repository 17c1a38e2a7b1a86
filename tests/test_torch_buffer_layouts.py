"""The torch port's buffer in each of the 12 layouts against the JAX
package's (the layout cases of tests/test_buffers.py): length and
emptiness, ``download_packed`` bit for bit as built, after ``update`` and
after ``update_range``, ``new_empty``'s zeros, and ``download_gaussians``
round-tripping the 3 reversible layouts and raising
IrreversibleConfigError on the 9 others.
"""

import numpy as np
import pytest

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu.errors as JE
import wgpu_3dgs_core_tpu_torch as T
import wgpu_3dgs_core_tpu_torch.errors as TE

from .common import gaussian_soa_with_seeds, gaussians_soa
from .test_torch_buffers import (
    REVERSIBLE,
    _buffers,
    _layout_id,
    _packed_bits_equal,
    _tlayout,
    _tsoa,
)
from .torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("layout", J.ALL_LAYOUTS, ids=_layout_id)
def test_buffer_layout(layout):
    jbuf, tbuf = _buffers(gaussians_soa(), layout)
    assert len(tbuf) == len(jbuf) == 2
    assert not tbuf.is_empty and not jbuf.is_empty
    empty = T.GaussiansBuffer.new_empty(0, _tlayout(layout), "cpu")
    assert empty.is_empty and J.GaussiansBuffer.new_empty(0, layout).is_empty

    # download_packed as built, after update and after update_range;
    # new_empty's zeros.
    jbuf, tbuf = _buffers(gaussian_soa_with_seeds([1, 2, 3, 4]), layout)
    _packed_bits_equal(jbuf.download_packed(), tbuf.download_packed())
    whole = gaussian_soa_with_seeds([5, 6, 7, 8])
    jbuf.update(whole)
    tbuf.update(_tsoa(whole))
    _packed_bits_equal(jbuf.download_packed(), tbuf.download_packed())
    sub = gaussian_soa_with_seeds([9, 10])
    jbuf.update_range(1, sub)
    tbuf.update_range(1, _tsoa(sub))
    _packed_bits_equal(jbuf.download_packed(), tbuf.download_packed())
    _packed_bits_equal(
        J.GaussiansBuffer.new_empty(3, layout).download_packed(),
        T.GaussiansBuffer.new_empty(3, _tlayout(layout), "cpu")
        .download_packed())

    soa = gaussians_soa()
    jbuf, tbuf = _buffers(soa, layout)
    if layout in REVERSIBLE:
        back, jback = tbuf.download_gaussians(), jbuf.download_gaussians()
        np.testing.assert_array_equal(back.pos, soa.pos)
        np.testing.assert_array_equal(back.color, soa.color)
        for name in ("rot", "pos", "color", "sh", "scale"):
            assert (getattr(back, name).tobytes()
                    == getattr(jback, name).tobytes())
    else:
        with pytest.raises(JE.IrreversibleConfigError):
            jbuf.download_gaussians()
        with pytest.raises(TE.IrreversibleConfigError):
            tbuf.download_gaussians()
        # but the packed download works
        assert tbuf.download_packed().cov3d.shape == (2, layout.cov3d_width)
