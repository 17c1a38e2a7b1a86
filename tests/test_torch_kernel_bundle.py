"""The torch port's kernel bundle (K8) against the JAX package's: the
dispatch cases of tests/test_kernel_bundle.py on the same numpy inputs,
each output held to the JAX bundle's bit for bit (f32 adds and products
round alike); the generated CUDA source; and the CUDA route's contract on
the CPU (no plain fallback, no rebuild), with ``on_cpu`` patched to
answer False. The builder's errors are in test_torch_kernel_bundle_errors,
the unpack of every layout in test_torch_unpack_bundle. The bundle kernels
run on the card in tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu.errors as JE
import wgpu_3dgs_core_tpu_torch as T
import wgpu_3dgs_core_tpu_torch.errors as TE
from wgpu_3dgs_core_tpu.ops import transforms as jtr
from wgpu_3dgs_core_tpu_torch.ops import kernel_bundle as kb
from wgpu_3dgs_core_tpu_torch.ops import unpack_bundle as ub

from .torch_parity import nn, one_torch_thread, tt  # noqa: F401


def _map_add(a, b, out, *, scale=1.0):
    """The array_map_add harness kernel (reference:
    tests/common/shader/array_map_add.wesl), the same body for a Pallas
    ref and a torch tile: out = (a + b) * scale."""
    out[...] = (a[...] + b[...]) * scale


MAP_ADD = T.BundleKernel(
    cuda="""
__device__ void map_add(const float* a, const float* b, float* out) {
  out[0] = __fmul_rn(__fadd_rn(a[0], b[0]), scale);
}""",
    entry="map_add", plain=_map_add)


def _sum_prod(a, b, c, s, p):
    s[...] = a[...] + b[...] + c[...]
    p[...] = a[...] * b[...] * c[...]


SUM_PROD = T.BundleKernel(
    cuda="""
__device__ void sum_prod(const float* a, const float* b, const float* c,
                         float* s, float* p) {
  s[0] = __fadd_rn(__fadd_rn(a[0], b[0]), c[0]);
  p[0] = __fmul_rn(__fmul_rn(a[0], b[0]), c[0]);
}""",
    entry="sum_prod", plain=_sum_prod)


def _times(k):
    def body(x, out):
        out[...] = x[...] * float(k)
    return body


def _times_kernel(k, width):
    return T.BundleKernel(
        cuda=f"""
__device__ void times{k}(const float* x, float* out) {{
  for (int j = 0; j < {width}; ++j) out[j] = __fmul_rn(x[j], {k}.0f);
}}""",
        entry=f"times{k}", plain=_times(k))


def _unpack_cov3d(cov3d, out, *, config):
    out[...] = (T.ops.unpack_cov3d if isinstance(out, torch.Tensor)
                else jtr.unpack_cov3d)(cov3d[...], rot_scale=config)


UNPACK_COV3D = T.BundleKernel(
    cuda="""
__device__ void unpack_cov3d(const float* c, float* out) {
  if (config) gs::unpack_cov3d_rot_scale(c, out);
  else gs::unpack_cov3d_single(c, out);
}""",
    entry="unpack_cov3d", plain=_unpack_cov3d)


def _builders(kernel=MAP_ADD, plain=_map_add):
    """The same bundle in both packages: (JAX builder, port builder)."""
    return (
        J.KernelBundleBuilder().label("array map add")
        .resource_layout(J.ResourceGroupLayout("inputs", arity=2))
        .kernel(plain).output(1, jnp.float32),
        T.KernelBundleBuilder().label("array map add")
        .resource_layout(T.ResourceGroupLayout("inputs", arity=2))
        .kernel(kernel).output(1, torch.float32),
    )


def _same(jax_out, port_out):
    """Port output equal to the JAX bundle's, bit for bit."""
    assert isinstance(port_out, torch.Tensor)
    np.testing.assert_array_equal(nn(port_out), np.asarray(jax_out))
    return nn(port_out)


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [tt(a) for a in arrays]


def test_map_add_dispatch():
    n = 1000  # not a multiple of the block: ragged tail
    (ja, jb), (ta, tb) = _both([np.arange(n, dtype=np.float32),
                                np.ones(n, np.float32)])
    jbld, tbld = _builders()
    got = _same(jbld.block_size(256).build([[ja, jb]]).dispatch(n),
                tbld.block_size(256).build([[ta, tb]]).dispatch(n))
    np.testing.assert_array_equal(got[:, 0], np.arange(n) + 1.0)


def test_map_add_with_override_constant():
    n = 64
    (ja, jb), (ta, tb) = _both([np.full(n, 2.0, np.float32),
                                np.full(n, 3.0, np.float32)])
    jbld, tbld = _builders()
    got = _same(
        jbld.constants(scale=10.0).block_size(64).build([[ja, jb]])
        .dispatch(n),
        tbld.constants(scale=10.0).block_size(64).build([[ta, tb]])
        .dispatch(n))
    np.testing.assert_array_equal(got[:, 0], 50.0)


def test_caller_managed_resources():
    n = 32
    (ja, jb), (ta, tb) = _both([np.ones(n, np.float32)] * 2)
    jbld, tbld = _builders()
    jbun = jbld.block_size(32).build_without_resources()
    tbun = tbld.block_size(32).build_without_resources()
    got = _same(jbun.dispatch(n, [[ja, jb]]), tbun.dispatch(n, [[ta, tb]]))
    np.testing.assert_array_equal(got[:, 0], 2.0)
    with pytest.raises(JE.KernelBundleResourceCountError):
        jbun.dispatch(n)
    with pytest.raises(TE.KernelBundleResourceCountError):
        tbun.dispatch(n)


def test_update_resources():
    n = 16
    ones, five, six = (np.full(n, v, np.float32) for v in (1.0, 5.0, 6.0))
    jbld, tbld = _builders()
    jbun = jbld.block_size(16).build([[jnp.asarray(ones)] * 2])
    tbun = tbld.block_size(16).build([[tt(ones)] * 2])
    jbun.update_resources([[jnp.asarray(five), jnp.asarray(six)]])
    tbun.update_resources([[tt(five), tt(six)]])
    got = _same(jbun.dispatch(n), tbun.dispatch(n))
    np.testing.assert_array_equal(got[:, 0], 11.0)


def test_multiple_groups_and_outputs():
    n = 128
    (ja, jb, jc), (ta, tb, tc) = _both(
        [np.full(n, v, np.float32) for v in (2.0, 3.0, 4.0)])

    def build(pkg, kernel):
        return (
            pkg.KernelBundleBuilder()
            .resource_layout(pkg.ResourceGroupLayout("ab", arity=2))
            .resource_layout(pkg.ResourceGroupLayout("c", arity=1))
            .kernel(kernel).output(1).output(1).block_size(64)
        )

    js, jp = build(J, _sum_prod).build([[ja, jb], [jc]]).dispatch(n)
    ts, tp = build(T, SUM_PROD).build([[ta, tb], [tc]]).dispatch(n)
    np.testing.assert_array_equal(_same(js, ts)[:, 0], 9.0)
    np.testing.assert_array_equal(_same(jp, tp)[:, 0], 24.0)


def test_vector_valued_items():
    """Items can be [N, F] rows, not just scalars."""
    n, f = 100, 8
    x = np.arange(n * f, dtype=np.float32).reshape(n, f)

    def build(pkg, kernel):
        return (pkg.KernelBundleBuilder()
                .resource_layout(pkg.ResourceGroupLayout("x", arity=1))
                .kernel(kernel).output(f).block_size(32))

    got = _same(build(J, _times(2)).build([[jnp.asarray(x)]]).dispatch(n),
                build(T, _times_kernel(2, f)).build([[tt(x)]]).dispatch(n))
    np.testing.assert_array_equal(got, x * 2.0)


def test_kernel_module_entry_points():
    n = 16
    ones = np.ones(n, np.float32)

    def build(pkg, module):
        return (pkg.KernelBundleBuilder()
                .resource_layout(pkg.ResourceGroupLayout("x", arity=1))
                .kernel_module(module).output(1).block_size(16)
                .entry_point("triple"))

    jout = build(J, {"double": _times(2), "triple": _times(3)}).build(
        [[jnp.asarray(ones)]]).dispatch(n)
    tout = build(T, {"double": _times_kernel(2, 1),
                     "triple": _times_kernel(3, 1)}).build(
        [[tt(ones)]]).dispatch(n)
    np.testing.assert_array_equal(_same(jout, tout)[:, 0], 3.0)


def test_dispatch_is_cached_no_rebuild(monkeypatch):
    """Build once, dispatch many: a second dispatch of one signature
    reuses its launcher (JAX: no retrace). The port's signature is the
    device and the resources' dtypes, all the generated source depends
    on: a new count reuses the launcher, new dtypes get their own. On the
    CUDA route (``on_cpu`` patched to False, nvcc and the launch stubbed)
    the source is built once and launched for each dispatch."""
    n = 256
    a, b = np.arange(n, dtype=np.float32), np.ones(n, np.float32)
    jbun = _builders()[0].build([[jnp.asarray(a), jnp.asarray(b)]])
    tbun = _builders()[1].build([[tt(a), tt(b)]])
    r1 = _same(jbun.dispatch(n), tbun.dispatch(n))
    r2 = _same(jbun.dispatch(n), tbun.dispatch(n))
    np.testing.assert_array_equal(r1, r2)
    assert len(tbun._dispatch_cache) == 1
    _same(jbun.dispatch(128, [[jnp.asarray(a[:128]), jnp.asarray(b[:128])]]),
          tbun.dispatch(128, [[tt(a[:128]), tt(b[:128])]]))
    assert len(tbun._dispatch_cache) == 1
    tbun.dispatch(n, [[tt(a).double(), tt(b).double()]])
    assert len(tbun._dispatch_cache) == 2

    builds, launches = [], []
    monkeypatch.setattr(kb, "on_cpu", lambda *t: False)
    monkeypatch.setattr(kb.cuda, "build_sources", lambda srcs: builds.append(
        srcs) or [kb.cuda.BuildInfo(None, 0.0, "")])
    monkeypatch.setattr(kb.cuda, "bundle_library", lambda path: None)
    monkeypatch.setattr(kb.cuda, "bind", lambda lib, sym, types: sym)
    monkeypatch.setattr(kb.KERNEL_BUNDLE, "call",
                        lambda fn, lib, *args, **kw: launches.append(
                            (fn, kw["work"])))
    card = _builders()[1].build([[tt(a), tt(b)]])
    card.dispatch(n)
    card.dispatch(n)
    card.dispatch(128, [[tt(a[:128]), tt(b[:128])]])
    assert len(builds) == 1
    assert launches == [(kb.BUNDLE_ENTRY, n), (kb.BUNDLE_ENTRY, n),
                        (kb.BUNDLE_ENTRY, 128)]
    assert "map_add(p...)" in builds[0][0]


def test_cuda_route_has_no_plain_fallback(monkeypatch):
    """On CUDA tensors (``on_cpu`` answering False) a bundle without CUDA
    source raises, and its plain version never runs."""
    ran = []
    monkeypatch.setattr(kb, "on_cpu", lambda *t: False)
    bundle = (T.KernelBundleBuilder()
              .resource_layout(T.ResourceGroupLayout("inputs", arity=2))
              .kernel(lambda a, b, out: ran.append(1)).output(1)
              .build([[tt(np.ones(4, np.float32))] * 2]))
    with pytest.raises(TE.MissingKernelError, match="no CUDA source"):
        bundle.dispatch(4)
    assert not ran


def test_bundle_source_text():
    """The generated CUDA source: the layout's 7 feature macros before the
    device library, the constants as constexpr values of their names (the
    plain version's defaults where the builder sets none), the kernel's
    source, and one extern "C" entry taking each resource and output."""
    layout = T.GaussianLayout(sh=T.ShFormat.NORM8,
                              cov3d=T.Cov3dFormat.HALF)
    src = kb.bundle_source(ub.UNPACK_GAUSSIANS,
                           [torch.float32, torch.uint8, torch.int8,
                            torch.float16], [torch.float32] * 4,
                           {"mt_px": 0.5, "steps": 3, "flag": True}, layout)
    lines = src.splitlines()
    defines = [ln for ln in lines if ln.startswith("#define ")]
    assert defines == ["#define GS_LAYOUT 1", "#define SH_SINGLE 0",
                       "#define SH_HALF 0", "#define SH_NORM8 1",
                       "#define SH_NONE 0", "#define COV3D_ROT_SCALE 0",
                       "#define COV3D_SINGLE 0", "#define COV3D_HALF 1"]
    assert lines.index(defines[-1]) < lines.index('#include "gaussian.cuh"')
    assert "constexpr float mt_px = static_cast<float>(0.5);" in lines
    assert "constexpr int steps = 3;" in lines
    assert "constexpr bool flag = true;" in lines
    assert src.count("GS_EXPORT") == 1  # common.cuh: extern "C", visible
    assert "GS_EXPORT int gs_bundle_launch(int count, int block," in lines
    assert "gs::Rows<const int8_t>{static_cast<const int8_t*>(in2), " \
        "w_in2}," in src
    assert src.count("long long w_out") == 4
    assert ub.UNPACK_SOURCE.strip() in src
    # The functor, and so every launch-state static instantiated with it,
    # is internal to its library.
    item = lines.index("struct gs_bundle_item {")
    assert lines[item - 1].startswith("namespace {")
    # A plain version's keyword defaults become constants; a scalar config
    # becomes a ``config`` constant.
    bun = _builders()[1].layout_config(True).build_without_resources()
    one = tt(np.ones(2, np.float32))
    text = bun.cuda_source(2, [[one, one]])
    assert "constexpr float scale = static_cast<float>(1.0);" in text
    assert "constexpr bool config = true;" in text
    assert "#define GS_LAYOUT" not in text
