"""The torch port's buffer layer against the JAX package's: the cases of
tests/test_buffers.py in both packages, on the same gaussians (the
per-layout cases are in test_torch_buffer_layouts). Each error is the same
class; the flag decoders agree with JAX's (max_std_dev within 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu.buffer as JB
import wgpu_3dgs_core_tpu.errors as JE
import wgpu_3dgs_core_tpu_torch as T
import wgpu_3dgs_core_tpu_torch.buffer as TB
import wgpu_3dgs_core_tpu_torch.errors as TE
from wgpu_3dgs_core_tpu_torch.convert import buffer_from_packed
from wgpu_3dgs_core_tpu_torch.ops import unpack_bundle as ub

from .common import gaussian_soa_with_seeds, gaussians_soa
from .torch_parity import nn, one_torch_thread  # noqa: F401

IRREVERSIBLE = [l for l in J.ALL_LAYOUTS
                if l.sh == J.ShFormat.NONE
                or l.cov3d != J.Cov3dFormat.ROT_SCALE]
REVERSIBLE = [l for l in J.ALL_LAYOUTS if l not in IRREVERSIBLE]


def _layout_id(l):
    return f"{l.sh.name.lower()}-{l.cov3d.name.lower()}"


def _tlayout(layout) -> T.GaussianLayout:
    return T.GaussianLayout(sh=T.ShFormat(layout.sh.value),
                            cov3d=T.Cov3dFormat(layout.cov3d.value))


def _tsoa(soa) -> T.GaussianSoA:
    return T.GaussianSoA(rot=soa.rot, pos=soa.pos, color=soa.color,
                         sh=soa.sh, scale=soa.scale)


def _buffers(soa, layout=J.GaussianLayout()):
    """The same gaussians in a JAX buffer and a port buffer (CPU)."""
    return (J.GaussiansBuffer.new(soa, layout),
            T.GaussiansBuffer.new(_tsoa(soa), _tlayout(layout), "cpu"))


def _packed_bits_equal(jp, tp):
    """Two PackedGaussians (numpy fields) equal bit for bit."""
    for name in ("pos", "color", "sh", "cov3d"):
        a, b = getattr(jp, name), getattr(tp, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_buffer_update():
    jbuf, tbuf = _buffers(gaussians_soa())
    soa2 = gaussian_soa_with_seeds([7, 8])
    tbuf.update(_tsoa(soa2))
    np.testing.assert_array_equal(tbuf.download_gaussians().pos, soa2.pos)
    bad = gaussian_soa_with_seeds([1, 2, 3])
    with pytest.raises(JE.GaussiansBufferUpdateError):
        jbuf.update(bad)
    with pytest.raises(TE.GaussiansBufferUpdateError) as err:
        tbuf.update(_tsoa(bad))
    assert (err.value.count, err.value.expected_count) == (3, 2)


def test_buffer_update_range():
    jbuf, tbuf = _buffers(gaussian_soa_with_seeds([1, 2, 3, 4]))
    sub = gaussian_soa_with_seeds([9])
    tbuf.update_range(2, _tsoa(sub))
    got = tbuf.download_gaussians()
    np.testing.assert_array_equal(got.pos[2], sub.pos[0])
    np.testing.assert_array_equal(got.pos[0],
                                  gaussian_soa_with_seeds([1]).pos[0])
    bad = gaussian_soa_with_seeds([1, 2])
    with pytest.raises(JE.GaussiansBufferUpdateRangeError):
        jbuf.update_range(3, bad)
    with pytest.raises(TE.GaussiansBufferUpdateRangeError) as err:
        tbuf.update_range(3, _tsoa(bad))
    assert (err.value.count, err.value.start, err.value.expected_count) == (
        2, 3, 4)


def test_update_range_writes_in_place():
    """update_range keeps every tensor's storage, so a bundle built with
    the buffer's tensors as resources sees the update (the JAX buffer
    builds new arrays; its bundle would need update_resources)."""
    _, tbuf = _buffers(gaussian_soa_with_seeds([1, 2, 3, 4]))
    ptrs = [t.data_ptr() for t in ub.resources(tbuf)]
    bundle = ub.unpack_bundle(tbuf)
    before = bundle.dispatch(4)
    sub = gaussian_soa_with_seeds([11, 12])
    tbuf.update_range(1, _tsoa(sub))
    assert [t.data_ptr() for t in ub.resources(tbuf)] == ptrs
    after = bundle.dispatch(4)
    d = tbuf.data
    want = ub.unpack_plain(d.pos, d.color, d.sh, d.cov3d, tbuf.layout)
    assert all(torch.equal(a, b) for a, b in zip(after, want))
    assert not torch.equal(before[0], after[0])
    np.testing.assert_array_equal(nn(after[0])[1:3, :3], sub.pos)


def test_buffer_from_arrays_validation():
    jbuf, tbuf = _buffers(gaussians_soa())
    d = tbuf.data
    ok = T.GaussiansBuffer.from_arrays(tbuf.layout, d.pos, d.color, d.sh,
                                       d.cov3d, device="cpu")
    assert len(ok) == 2
    jd = jbuf.data
    with pytest.raises(JE.GaussiansBufferTryFromBufferError):
        J.GaussiansBuffer.from_arrays(jbuf.layout, jd.pos, jd.color, jd.sh,
                                      jd.cov3d[:, :5])
    with pytest.raises(TE.GaussiansBufferTryFromBufferError):
        T.GaussiansBuffer.from_arrays(tbuf.layout, d.pos, d.color, d.sh,
                                      d.cov3d[:, :5], device="cpu")


def test_buffer_nbytes():
    jbuf, tbuf = _buffers(gaussians_soa())
    assert tbuf.nbytes == jbuf.nbytes == 2 * tbuf.layout.bytes_per_gaussian


def test_buffer_from_packed():
    """convert.buffer_from_packed carries a JAX buffer's download into a
    port buffer unchanged."""
    layout = J.GaussianLayout(sh=J.ShFormat.HALF, cov3d=J.Cov3dFormat.HALF)
    jbuf = J.GaussiansBuffer.new(gaussians_soa(), layout)
    tbuf = buffer_from_packed(jbuf.download_packed(), device="cpu")
    assert tbuf.layout == _tlayout(layout) and tbuf.device.type == "cpu"
    _packed_bits_equal(jbuf.download_packed(), tbuf.download_packed())


# ---------------------------------------------------------------- uniforms


def test_gaussian_transform_flags_roundtrip():
    kw = dict(size=2.5, sh_deg=2, no_sh0=True, max_std_dev=1.5)
    t = T.GaussianTransform(display_mode=T.GaussianDisplayMode.ELLIPSE, **kw)
    jt = J.GaussianTransform(display_mode=J.GaussianDisplayMode.ELLIPSE,
                             **kw)
    size, flags = t.to_pod()
    assert (size, flags) == jt.to_pod()
    for flag_in in (flags, torch.tensor(flags, dtype=torch.int64)):
        assert int(TB.gaussian_transform_display_mode(flag_in)) == 1
        assert int(TB.gaussian_transform_sh_deg(flag_in)) == 2
        assert bool(TB.gaussian_transform_no_sh0(flag_in))
        np.testing.assert_allclose(
            float(TB.gaussian_transform_max_std_dev(flag_in)),
            float(JB.gaussian_transform_max_std_dev(flags)), atol=1e-6)
    for name in ("display_mode", "sh_deg", "no_sh0"):
        assert (getattr(TB, f"gaussian_transform_{name}")(flags)
                == getattr(JB, f"gaussian_transform_{name}")(flags))
    t2 = T.GaussianTransform.from_pod(size, flags)
    assert (t2.display_mode, t2.sh_deg, t2.no_sh0) == (
        t.display_mode, t.sh_deg, t.no_sh0)


def test_gaussian_transform_defaults():
    t = T.GaussianTransform()
    assert t.size == 1.0
    assert t.display_mode == T.GaussianDisplayMode.SPLAT
    assert t.sh_deg == 3 and not t.no_sh0 and t.max_std_dev == 3.0
    assert t.to_pod() == J.GaussianTransform().to_pod()
    assert (t.to_pod()[1] >> 24) & 0xFF == 255


def test_gaussian_transform_validation():
    for pkg in (J, T):
        with pytest.raises(ValueError, match="SH degree"):
            pkg.GaussianTransform(sh_deg=4)
        for bad in (3.5, -0.1):
            with pytest.raises(ValueError, match="max std dev"):
                pkg.GaussianTransform(max_std_dev=bad)


def test_model_transform_defaults_and_update():
    mt = T.ModelTransform()
    for got, want in zip(mt.as_tensors("cpu"), J.ModelTransform().as_arrays()):
        np.testing.assert_array_equal(nn(got), np.asarray(want))
    mt2 = mt.update(pos=(1, 2, 3))
    assert mt2.pos == (1, 2, 3) and mt2.rot == mt.rot


def test_fixed_size_wrapper():
    """Accepts exactly one POD's bytes and downloads it; rejects any other
    size with the sizes in the error."""
    t = torch.zeros((2, 4), dtype=torch.float32)  # 32 bytes
    w = T.FixedSizeBufferWrapper(t, expected_nbytes=32)
    got = w.download_single()
    jgot = J.FixedSizeBufferWrapper(jnp.zeros((2, 4), jnp.float32),
                                    expected_nbytes=32).download_single()
    assert got.shape == jgot.shape == (2, 4) and got.dtype == jgot.dtype
    assert w.buffer is t
    with pytest.raises(JE.FixedSizeBufferWrapperError):
        J.FixedSizeBufferWrapper(jnp.zeros((3,), jnp.float32),
                                 expected_nbytes=16)
    with pytest.raises(TE.FixedSizeBufferWrapperError) as err:
        T.FixedSizeBufferWrapper(torch.zeros(3), expected_nbytes=16)
    assert (err.value.buffer_size, err.value.expected_size) == (12, 16)


def test_download_helper_and_error():
    got = T.download(torch.arange(8, dtype=torch.float32))
    want = J.download(jnp.arange(8, dtype=jnp.float32))
    np.testing.assert_array_equal(got, want)
    # The reference's failed map (src/error.rs:56-63): a tensor with no
    # storage to copy, as a deleted array is in the JAX package.
    with pytest.raises(TE.DownloadBufferError):
        T.download(torch.empty(4, device="meta"))
