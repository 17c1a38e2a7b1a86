"""Kernel bundle: the compute-dispatch abstraction, and kernel K8.

The counterpart of ``wgpu_3dgs_core_tpu.ops.kernel_bundle`` (reference:
src/compute_bundle.rs, ComputeBundle/ComputeBundleBuilder): a validated
launcher of 1-D map kernels over ``count`` items, with the JAX package's
builder API and errors.

- bind group layouts       -> ResourceGroupLayout arity validation
- WESL feature flags       -> ``layout_config``: a GaussianLayout becomes
                              the 7 feature macros of the generated source
                              (its ``features()``, the reference's
                              wesl_features); a bool or number becomes a
                              ``config`` constant
- ``workgroup_size``       -> ``block_size`` (grid = ceil(count / block))
- override constants       -> ``constants``: constexpr values of the same
                              names in the generated source, keyword
                              arguments of the plain version
- dispatch(encoder, count) -> dispatch(count) returning tensors [count, W]

A bundle kernel is a :class:`BundleKernel`, a pair. ``cuda`` is CUDA C++
source defining a per-item ``__device__`` function named ``entry``: it
takes one pointer per resource (in group order) to item i's row, then one
pointer per output to item i's output row, and may call the device library
``csrc/gaussian.cuh`` (namespace ``gs``). ``plain`` is a torch function with
the JAX kernel's signature, ``fn(*in_tiles, *out_tiles, **statics)``,
writing ``out[...] = ...``.

Dispatch follows the device of the resources (ops/cuda.py ``on_cpu``):

- CPU tensors run the plain launcher, K8's plain version: the resources are
  zero-padded to grid x block rows and ``plain`` runs once per block on
  [block, F] views, as Pallas runs the body.
- CUDA tensors launch K8: for each dispatch signature the bundle generates
  a small source (:func:`bundle_source`, a pure function) that includes
  ``csrc/bundle.cuh``'s ``__global__`` map templates, builds it with nvcc
  (ops/cuda.py ``build_sources``, cached on disk by the source's hash) and
  launches it: a block per tile of :func:`tile_plan` items, moved through
  shared memory by bulk async copies; launches count as
  ``kernel_bundle``. There is no fallback: a bundle without CUDA source, a
  failed build or a failed launch raises.

A dispatch re-checks only what can change between calls: the resources
the bundle owns are validated and flattened when they are set (``build``,
``update_resources``), and each call compares their pointers and shapes
and the count; the arguments' layout is kept per signature.

Deliberate divergences from the JAX package: ``MAX_BLOCK_SIZE`` is 1024,
CUDA's limit of threads per block, where the TPU's was 8192 (bounded by
VMEM); ``DEFAULT_BLOCK_SIZE`` is 256, where the TPU's was 1024, so that a
kernel using up to 255 registers a thread still launches; a bundle kernel
is a CUDA source + plain pair where the JAX package takes one Pallas body.
"""

from __future__ import annotations

import inspect
import logging
import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Sequence

import torch

from . import cuda
from ..errors import (
    KernelBundleResourceCountError,
    KernelBundleWorkgroupLimitError,
    MissingEntryPointError,
    MissingKernelError,
    MissingLayoutConfigError,
    MissingResourceLayoutError,
)
from .cuda import I, L, P, Launcher, on_cpu

log = logging.getLogger(__name__)

MAX_BLOCK_SIZE = 1024
DEFAULT_BLOCK_SIZE = 256

BUNDLE_ENTRY = "gs_bundle_launch"
KERNEL_BUNDLE = Launcher("kernel_bundle")

# The tiled map (csrc/bundle.cuh) on sm_90 (H100, H200), the only target
# the kernels are built for, where a block may opt in to 232,448 bytes of
# shared memory. A tile's rows take at most TILE_BYTES, so that four
# blocks share an SM's 233,472 bytes (the runtime keeps 1,024 a block),
# and each thread runs at most ITEMS_PER_THREAD items: the best of the
# sizes timed on the card for the unpack and map_add (PERF.md).
SMEM_OPTIN = 232_448
BARRIER_BYTES = 8  # the tile's mbarrier (csrc/bundle.cuh kBarrierBytes)
TILE_GRANULE = 16  # items: a tile of any row width is whole 16-byte words
TILE_BYTES = 52 * 1024
ITEMS_PER_THREAD = 4


# torch dtype -> C type of a resource or output element: the packed
# layouts' element types, and int32.
C_TYPES = {
    torch.float32: "float",
    torch.float16: "__half",
    torch.int8: "int8_t",
    torch.uint8: "uint8_t",
    torch.int32: "int32_t",
}


@dataclass(frozen=True)
class BundleKernel:
    """One bundle kernel: CUDA source of the per-item ``__device__``
    function ``entry`` and its plain torch version (either may be None: a
    bundle without ``cuda`` raises on a CUDA dispatch, one without
    ``plain`` on a CPU dispatch)."""

    cuda: Optional[str] = None
    entry: Optional[str] = None
    plain: Optional[Callable] = None

    def __post_init__(self):
        if self.cuda is not None and not self.entry:
            raise ValueError("a BundleKernel with CUDA source names its entry")
        if self.cuda is None and self.plain is None:
            raise ValueError("a BundleKernel needs CUDA source or a plain "
                             "version")


def _as_kernel(fn) -> BundleKernel:
    return fn if isinstance(fn, BundleKernel) else BundleKernel(plain=fn)


@dataclass(frozen=True)
class ResourceGroupLayout:
    """Declares one group of same-lifetime resources, the analog of a
    wgpu::BindGroupLayoutDescriptor (reference: compute_bundle.rs:383-390)."""

    label: str
    arity: int


@dataclass(frozen=True)
class OutputSpec:
    """Per-item output: each dispatched item produces a [width] vector."""

    width: int
    dtype: torch.dtype = torch.float32


def tile_plan(row_bytes: Sequence[int], block: int) -> int:
    """Items a tile of the tiled map, for a signature whose resource and
    output rows take ``row_bytes`` bytes, in blocks of ``block`` threads:
    the largest multiple of 16 whose rows fit TILE_BYTES, at most
    ITEMS_PER_THREAD a thread; 16 for rows too wide for that while 16 fit
    a block's opt-in limit; else 0, the direct kernel."""
    per_item = max(sum(row_bytes), 1)  # rows of width 0 take no bytes
    g = TILE_GRANULE
    items = min(TILE_BYTES // per_item, ITEMS_PER_THREAD * block) // g * g
    if items >= g:
        return items
    return g if tile_smem(row_bytes, g) <= SMEM_OPTIN else 0


def tile_smem(row_bytes: Sequence[int], items: int) -> int:
    """Shared bytes a block of the tiled map takes for a tile of
    ``items``."""
    return sum(-(-b * items // 16) * 16 for b in row_bytes) + BARRIER_BYTES


# ------------------------------------------------------ source generation


def _c_value(value) -> tuple[str, str]:
    """(C type, literal) of a constant: bool, int or float."""
    if isinstance(value, bool):
        return "bool", "true" if value else "false"
    if isinstance(value, int):
        return ("int" if -2**31 <= value < 2**31 else "long long"), str(value)
    if isinstance(value, float):
        if not math.isfinite(value):
            raise ValueError(f"bundle constant {value!r} is not finite")
        # The double literal converts to float with one rounding, as torch
        # converts a Python number operand of an f32 tensor.
        return "float", f"static_cast<float>({value!r})"
    raise TypeError(f"bundle constant {value!r}: expected bool, int or "
                    "float")


def _constant_lines(constants: Mapping[str, Any]) -> list[str]:
    lines = []
    for name, value in constants.items():
        if hasattr(value, "item"):  # a numpy or torch scalar
            value = value.item()
        ctype, literal = _c_value(value)
        lines.append(f"constexpr {ctype} {name} = {literal};")
    return lines


def _config_lines(config) -> list[str]:
    """A GaussianLayout (anything with ``features()``) -> its feature
    macros; a bool or number -> one constexpr ``config``."""
    if config is None:
        return []
    if hasattr(config, "features"):
        return ["#define GS_LAYOUT 1"] + [
            f"#define {name.upper()} {int(on)}"
            for name, on in config.features()
        ]
    return _constant_lines({"config": config})


def bundle_source(kernel: BundleKernel, in_dtypes: Sequence[torch.dtype],
                  out_dtypes: Sequence[torch.dtype],
                  constants: Mapping[str, Any], config=None) -> str:
    """The CUDA source of one bundle signature: the layout's feature
    macros, the device library and csrc/bundle.cuh, the constants, the
    kernel's source, and one ``extern "C"`` entry launching the map.

    It depends on the kernel, the element types and the constants and
    config only (not on the count, the row widths, the block size or the
    tile plan, which the entry takes at run time), so bundles that share
    them share one build."""
    if kernel.cuda is None:
        raise MissingKernelError("bundle kernel has no CUDA source")
    for dt in (*in_dtypes, *out_dtypes):
        if dt not in C_TYPES:
            raise TypeError(f"no CUDA element type for {dt}")
    is_layout = config is not None and hasattr(config, "features")
    params = ([f"const void* in{k}, long long w_in{k}"
               for k in range(len(in_dtypes))]
              + [f"void* out{k}, long long w_out{k}"
                 for k in range(len(out_dtypes))])
    rows = ([f"gs::Rows<const {C_TYPES[dt]}>{{"
             f"static_cast<const {C_TYPES[dt]}*>(in{k}), w_in{k}}}"
             for k, dt in enumerate(in_dtypes)]
            + [f"gs::Rows<{C_TYPES[dt]}>{{"
               f"static_cast<{C_TYPES[dt]}*>(out{k}), w_out{k}}}"
               for k, dt in enumerate(out_dtypes)])
    lines = [
        "// Kernel bundle source generated by "
        "wgpu_3dgs_core_tpu_torch.ops.kernel_bundle.",
        *(_config_lines(config) if is_layout else []),
        '#include "gaussian.cuh"',
        '#include "bundle.cuh"',
        "",
        *(_config_lines(config) if not is_layout else []),
        *_constant_lines(constants),
        "",
        kernel.cuda.strip(),
        "",
        "namespace {  // internal: each bundle library keeps its own launch state",
        "struct gs_bundle_item {",
        "  template <typename... P>",
        "  __device__ __forceinline__ void operator()(P... p) const {",
        f"    {kernel.entry}(p...);",
        "  }",
        "};",
        "}  // namespace",
        "",
        f"GS_EXPORT int {BUNDLE_ENTRY}(int count, int block,",
        "    int tile,",
        *(f"    {p}," for p in params),
        "    void* stream) {",
        "  return gs::launch_map<gs_bundle_item>(count, block, tile, stream,",
        ",\n".join(f"      {r}" for r in rows) + ");",
        "}",
        "",
    ]
    return "\n".join(lines)


def _plain_defaults(fn: Optional[Callable]) -> dict[str, Any]:
    """Keyword defaults of the plain version (``config`` aside): the
    constants both routes see when the builder sets none."""
    if fn is None:
        return {}
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return {}
    return {p.name: p.default for p in params
            if p.kind == p.KEYWORD_ONLY and p.name != "config"
            and p.default is not p.empty}


# ---------------------------------------------------------------- bundle


class _Owned:
    """The resources a bundle owns, flattened once: the [count, W] views a
    dispatch hands the kernel, the tensors they view with the pointer and
    shape each had, and the signature's runner once a dispatch has found
    it."""

    __slots__ = ("src", "flat", "ptrs", "shapes", "rows", "run")

    @classmethod
    def of(cls, resources) -> Optional["_Owned"]:
        """None where a dispatch must flatten the resources itself: a
        resource that is not a contiguous tensor of 1 or 2 dims (its flat
        form would be a copy, blind to updates in place, or is no [count,
        W] array), or row counts that differ (every dispatch raises)."""
        src = [t for group in resources for t in group]
        if not all(isinstance(t, torch.Tensor) and t.dim() in (1, 2)
                   and t.is_contiguous() for t in src):
            return None
        rows = {t.shape[0] for t in src}
        if len(rows) != 1:
            return None
        owned = cls()
        owned.src = src
        owned.flat = [t[:, None] if t.dim() == 1 else t for t in src]
        owned.ptrs = [t.data_ptr() for t in src]
        owned.shapes = [t.shape for t in src]
        (owned.rows,) = rows
        owned.run = None
        return owned

    def current(self) -> bool:
        """Whether every resource still has the storage and shape it had
        when flattened (an update in place keeps both)."""
        return all(t.data_ptr() == p and t.shape == s
                   for t, p, s in zip(self.src, self.ptrs, self.shapes))


class KernelBundle:
    """A built, dispatchable kernel (reference: ComputeBundle,
    compute_bundle.rs:49-60).

    Created by :class:`KernelBundleBuilder`. If built with resources, they
    are owned by the bundle (the ``ComputeBundle<wgpu::BindGroup>`` type
    state); otherwise pass resources at dispatch (``ComputeBundle<()>``,
    compute_bundle.rs:255-352).
    """

    def __init__(self, label, layouts, kernel: BundleKernel, outputs,
                 block_size, constants, config, resources):
        self.label = label
        self._layouts = layouts
        self._kernel = kernel
        self._outputs = outputs
        self.block_size = block_size
        self._constants = dict(constants)
        self._config = config
        self._resources = resources
        self._owned: Optional[_Owned] = None
        # Build once, dispatch many (reference: compute_bundle.rs:311-330):
        # one runner per (device, resource dtypes), what the generated
        # source depends on; the count and row widths are run-time
        # arguments of the launcher.
        self._dispatch_cache: dict[Any, Any] = {}

    def update_resources(self, resources: Sequence[Sequence[Any]]) -> None:
        """Re-point the bundle at new tensors (reference:
        compute_bundle.rs:204-228)."""
        self._resources = _validate_resources(self._layouts, resources)
        self._owned = _Owned.of(self._resources)

    def _flat(self, count: int, resources) -> list[torch.Tensor]:
        if resources is None:
            resources = self._resources
            if resources is None:
                raise KernelBundleResourceCountError(
                    layout_index=0, resource_count=0,
                    expected_count=self._layouts[0].arity,
                )
        else:
            resources = _validate_resources(self._layouts, resources)
        flat = []
        for t in (t for group in resources for t in group):
            t = torch.as_tensor(t)
            if t.dim() == 1:
                t = t[:, None]
            if t.dim() != 2 or t.shape[0] != count:
                raise ValueError(
                    f"{self.label}: resource of shape {tuple(t.shape)}, "
                    f"dispatch count is {count}"
                )
            flat.append(t.contiguous())
        return flat

    def _statics(self) -> dict[str, Any]:
        statics = dict(self._constants)
        if self._config is not None:
            statics["config"] = self._config
        return statics

    def cuda_source(self, count: int, resources=None) -> str:
        """The generated source of a dispatch of ``count`` items."""
        return self._source(self._flat(count, resources))

    def _source(self, flat) -> str:
        return bundle_source(
            self._kernel, [t.dtype for t in flat],
            [o.dtype for o in self._outputs],
            {**_plain_defaults(self._kernel.plain), **self._constants},
            self._config,
        )

    def dispatch(self, count: int, resources: Optional[Sequence] = None):
        """Run the kernel over ``count`` items
        (reference: compute_bundle.rs:114-132). Returns one [count, W]
        tensor per output (a tuple when there are several)."""
        owned = self._owned if resources is None else None
        if owned is not None and not owned.current():
            owned = self._owned = _Owned.of(self._resources)
        if owned is not None and count == owned.rows:
            flat = owned.flat
            run = owned.run
            if run is None:
                run = owned.run = self._runner(flat)
        else:  # validate and flatten this call's resources
            flat = self._flat(count, resources)
            run = self._runner(flat)
        result = tuple(run(count, flat))
        return result if len(result) > 1 else result[0]

    def _runner(self, flat):
        """The runner of this signature: the plain launcher on CPU
        tensors, else the built CUDA entry."""
        cpu = on_cpu(*flat)
        key = (flat[0].device, tuple(t.dtype for t in flat))
        run = self._dispatch_cache.get(key)
        if run is None:
            run = self._dispatch_plain if cpu else self._build_cuda(flat)
            self._dispatch_cache[key] = run
        return run

    def _dispatch_plain(self, count: int, flat):
        """K8's plain version: pad to whole blocks with zeros and run the
        plain kernel once per block on [block, F] views."""
        if self._kernel.plain is None:
            raise MissingKernelError(
                f"{self.label}: bundle kernel has no plain version for CPU "
                "tensors")
        block = self.block_size
        grid = -(-count // block)
        padded = grid * block
        ins = [torch.cat([t, t.new_zeros((padded - count, t.shape[1]))])
               for t in flat]
        outs = [torch.zeros((padded, o.width), dtype=o.dtype)
                for o in self._outputs]
        statics = self._statics()
        for b in range(grid):
            rows = slice(b * block, (b + 1) * block)
            self._kernel.plain(*(t[rows] for t in ins),
                               *(o[rows] for o in outs), **statics)
        return [o[:count] for o in outs]

    def _build_cuda(self, flat):
        """Generate, build (or find built) and bind the entry of this
        signature; returns its runner. The runner keeps, per row widths,
        the arguments ahead of the pointers: the block and the tile's
        items."""
        if self._kernel.cuda is None:
            raise MissingKernelError(
                f"{self.label}: bundle kernel has no CUDA source; CUDA "
                "tensors need one (there is no plain fallback)")
        (info,) = cuda.build_sources([self._source(flat)])
        lib = cuda.bundle_library(info.path)
        outputs = self._outputs
        argtypes = [I, I, I] + [P, L] * (len(flat) + len(outputs))
        fn = cuda.bind(lib, BUNDLE_ENTRY, argtypes)
        block = self.block_size
        out_bytes = [o.width * o.dtype.itemsize for o in outputs]
        heads: dict[tuple, tuple] = {}

        def run(count, flat):
            widths = tuple(t.shape[1] for t in flat)
            head = heads.get(widths)
            if head is None:
                head = heads[widths] = (
                    block, tile_plan([w * t.element_size()
                                      for w, t in zip(widths, flat)]
                                     + out_bytes, block))
            dev = flat[0].device
            outs = [torch.empty((count, o.width), dtype=o.dtype, device=dev)
                    for o in outputs]
            args = [count, *head]
            for t, w in zip(flat, widths):
                args += (t.data_ptr(), w)
            for t, o in zip(outs, outputs):
                args += (t.data_ptr(), o.width)
            KERNEL_BUNDLE.call(fn, lib, *args, work=count, device=dev)
            return outs

        return run


def _validate_resources(layouts, resources):
    if len(resources) != len(layouts):
        raise KernelBundleResourceCountError(
            layout_index=min(len(resources), len(layouts)),
            resource_count=len(resources),
            expected_count=len(layouts),
        )
    for i, (layout, group) in enumerate(zip(layouts, resources)):
        if len(group) != layout.arity:
            raise KernelBundleResourceCountError(
                layout_index=i,
                resource_count=len(group),
                expected_count=layout.arity,
            )
    return [list(group) for group in resources]


# --------------------------------------------------------------- builder


class KernelBundleBuilder:
    """Fluent builder (reference: ComputeBundleBuilder,
    compute_bundle.rs:364-497)."""

    def __init__(self):
        self._label = "Kernel Bundle"
        self._layouts: list[ResourceGroupLayout] = []
        self._module: Optional[dict[str, BundleKernel]] = None
        self._entry_point: Optional[str] = None
        self._outputs: list[OutputSpec] = []
        self._block_size: Optional[int] = None
        self._constants: dict[str, Any] = {}
        self._config: Any = None

    def label(self, label: str) -> "KernelBundleBuilder":
        self._label = label
        return self

    def resource_layout(self,
                        layout: ResourceGroupLayout) -> "KernelBundleBuilder":
        self._layouts.append(layout)
        return self

    def resource_layouts(self, layouts) -> "KernelBundleBuilder":
        self._layouts.extend(layouts)
        return self

    def kernel(self, fn) -> "KernelBundleBuilder":
        """Single-kernel module (main shader analog): ``fn`` a BundleKernel,
        or a plain function alone (CPU dispatch only)."""
        self._module = {"main": _as_kernel(fn)}
        self._entry_point = "main"
        return self

    def kernel_module(self,
                      module: Mapping[str, Any]) -> "KernelBundleBuilder":
        """Named kernels; select with entry_point
        (main_shader analog, compute_bundle.rs:449-456)."""
        self._module = {k: _as_kernel(v) for k, v in module.items()}
        return self

    def entry_point(self, name: str) -> "KernelBundleBuilder":
        self._entry_point = name
        return self

    def output(self, width: int,
               dtype: torch.dtype = torch.float32) -> "KernelBundleBuilder":
        self._outputs.append(OutputSpec(width, dtype))
        return self

    def block_size(self, block_size: int) -> "KernelBundleBuilder":
        """The workgroup_size override (reference:
        compute_bundle.rs:489-496)."""
        self._block_size = block_size
        return self

    def constants(self, **constants) -> "KernelBundleBuilder":
        """Pipeline-overridable constants (reference:
        compute_bundle.rs:311-330): keyword arguments of the plain
        version, constexpr values of the CUDA source."""
        self._constants.update(constants)
        return self

    def layout_config(self, config) -> "KernelBundleBuilder":
        """Static layout specialization, the WESL feature-flag analog
        (reference: GaussianPod::wesl_features, src/buffer/gaussian.rs:
        289-298): ``config=`` of the plain version; the feature macros (a
        GaussianLayout) or a ``config`` constant (a bool or number) of the
        CUDA source."""
        self._config = config
        return self

    def build(self, resources: Sequence[Sequence[Any]]) -> KernelBundle:
        """Build with bundle-owned resources
        (reference: compute_bundle.rs:500-543)."""
        bundle = self.build_without_resources()
        bundle.update_resources(resources)
        return bundle

    def build_without_resources(self) -> KernelBundle:
        """Build with caller-managed resources
        (reference: compute_bundle.rs:546-586)."""
        if not self._layouts:
            raise MissingResourceLayoutError(
                f"{self._label}: no resource group layouts"
            )
        if self._module is None:
            raise MissingKernelError(f"{self._label}: no kernel")
        if self._entry_point is None:
            raise MissingEntryPointError(f"{self._label}: no entry point")
        if self._entry_point not in self._module:
            raise MissingEntryPointError(
                f"{self._label}: entry point {self._entry_point!r} not in "
                f"module {sorted(self._module)}"
            )
        outputs = self._outputs or [OutputSpec(1, torch.float32)]
        kernel = self._module[self._entry_point]

        # A plain version declaring a required ``config`` parameter is
        # layout-specialized: building it without .layout_config(...) is
        # the reference's missing-features error (compute_bundle.rs:505-519).
        if self._config is None and kernel.plain is not None:
            try:
                params = inspect.signature(kernel.plain).parameters
            except (TypeError, ValueError):
                params = {}
            cfg = params.get("config")
            if cfg is not None and cfg.default is inspect.Parameter.empty:
                raise MissingLayoutConfigError(
                    f"{self._label}: kernel {self._entry_point!r} requires a "
                    "layout config; call .layout_config(...) before build"
                )

        block = self._block_size or DEFAULT_BLOCK_SIZE
        if block > MAX_BLOCK_SIZE:
            raise KernelBundleWorkgroupLimitError(
                workgroup_size=block, limit=MAX_BLOCK_SIZE
            )

        log.debug("building kernel bundle %r (block=%d)", self._label, block)
        return KernelBundle(
            label=self._label,
            layouts=tuple(self._layouts),
            kernel=kernel,
            outputs=tuple(outputs),
            block_size=block,
            constants=self._constants,
            config=self._config,
            resources=None,
        )
