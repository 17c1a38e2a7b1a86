"""The torch port's kernel-bundle builder against the JAX package's:
every error case of tests/test_kernel_bundle.py raises the same error
class in both packages (reference: tests/e2e/compute_bundle.rs:242-378),
and the config-specialised cov3d unpack of that file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wgpu_3dgs_core_tpu as J
import wgpu_3dgs_core_tpu.errors as JE
import wgpu_3dgs_core_tpu_torch as T
import wgpu_3dgs_core_tpu_torch.errors as TE

from .common import gaussians_soa
from .test_torch_kernel_bundle import (
    MAP_ADD,
    UNPACK_COV3D,
    _builders,
    _map_add,
    _unpack_cov3d,
)
from .torch_parity import nn, one_torch_thread, tt  # noqa: F401


def _raise_both(jexc, texc, make, match=None):
    with pytest.raises(jexc, match=match):
        make(J, _map_add)
    with pytest.raises(texc, match=match):
        make(T, MAP_ADD)
    assert jexc.__name__ == texc.__name__


def test_missing_resource_layout():
    _raise_both(
        JE.MissingResourceLayoutError, TE.MissingResourceLayoutError,
        lambda pkg, k: pkg.KernelBundleBuilder().kernel(k)
        .build_without_resources())


def test_missing_kernel():
    _raise_both(
        JE.MissingKernelError, TE.MissingKernelError,
        lambda pkg, k: pkg.KernelBundleBuilder()
        .resource_layout(pkg.ResourceGroupLayout("x", arity=1))
        .build_without_resources())


def test_missing_entry_point():
    _raise_both(
        JE.MissingEntryPointError, TE.MissingEntryPointError,
        lambda pkg, k: pkg.KernelBundleBuilder()
        .resource_layout(pkg.ResourceGroupLayout("x", arity=1))
        .kernel_module({"a": k, "b": k}).build_without_resources())


def test_unknown_entry_point():
    _raise_both(
        JE.MissingEntryPointError, TE.MissingEntryPointError,
        lambda pkg, k: pkg.KernelBundleBuilder()
        .resource_layout(pkg.ResourceGroupLayout("x", arity=1))
        .kernel_module({"a": k}).entry_point("nope")
        .build_without_resources(),
        match="nope")


def test_block_size_limit():
    """Both packages refuse 1 << 20; the port's limit is CUDA's 1024
    threads a block (the TPU's was 8192), so it refuses 1025 and takes
    1024."""
    _raise_both(
        JE.KernelBundleWorkgroupLimitError,
        TE.KernelBundleWorkgroupLimitError,
        lambda pkg, k: _builders()[pkg is T].block_size(1 << 20)
        .build_without_resources())
    assert T.ops.MAX_BLOCK_SIZE == 1024
    with pytest.raises(TE.KernelBundleWorkgroupLimitError) as err:
        _builders()[1].block_size(1025).build_without_resources()
    assert (err.value.workgroup_size, err.value.limit) == (1025, 1024)
    assert _builders()[1].block_size(1024).build_without_resources() \
        .block_size == 1024


def test_resource_count_mismatch():
    n = 8
    ones = np.ones(n, np.float32)
    for groups in ([[ones]], [[ones, ones], [ones]]):
        _raise_both(
            JE.KernelBundleResourceCountError,
            TE.KernelBundleResourceCountError,
            lambda pkg, k: _builders()[pkg is T].build(
                [[(jnp.asarray if pkg is J else tt)(a) for a in g]
                 for g in groups]))


def test_unpack_cov3d_via_bundle():
    """The JAX suite's shader-test analog (reference:
    tests/shader/gaussian.rs): ROT_SCALE sigma unpacked inside a
    config-specialised bundle, against the host SINGLE packing (the JAX
    suite's bar, atol 1e-3) and against the JAX bundle within 1e-6 of the
    row's largest |sigma| (the entries cancel from ~1e4 down to ~1e-4, and
    the Pallas body contracts in another order)."""
    soa = gaussians_soa()
    packed = J.pack(soa, J.GaussianLayout()).cov3d

    def build(pkg, kernel, dtype):
        return (pkg.KernelBundleBuilder().label("unpack cov3d")
                .resource_layout(pkg.ResourceGroupLayout("gaussians", 1))
                .kernel(kernel).layout_config(True).output(6, dtype)
                .block_size(8))

    jout = build(J, _unpack_cov3d, jnp.float32).build(
        [[jnp.asarray(packed)]]).dispatch(2)
    tout = build(T, UNPACK_COV3D, torch.float32).build(
        [[tt(packed)]]).dispatch(2)
    err = np.abs(nn(tout) - np.asarray(jout)).max(axis=1)
    assert (err <= 1e-6 * np.abs(np.asarray(jout)).max(axis=1)).all(), err
    expected = J.pack(soa, J.GaussianLayout(cov3d=J.Cov3dFormat.SINGLE)).cov3d
    np.testing.assert_allclose(nn(tout), expected, atol=1e-3, rtol=1e-5)


def test_missing_layout_config():
    """A kernel whose plain version requires ``config`` needs
    .layout_config() before build, in both packages."""

    def copy(x, out, *, config):
        out[...] = x[...]

    for pkg, kernel, exc in (
        (J, copy, JE.MissingLayoutConfigError),
        (T, T.BundleKernel(cuda="__device__ void copy(const float* x, "
                           "float* o) { o[0] = x[0]; }", entry="copy",
                           plain=copy), TE.MissingLayoutConfigError),
    ):
        builder = (pkg.KernelBundleBuilder()
                   .resource_layout(pkg.ResourceGroupLayout("io", 1))
                   .kernel(kernel).output(1))
        with pytest.raises(exc):
            builder.build_without_resources()
        builder.layout_config({"dtype": "f32"}).build_without_resources()
