"""Device buffer layer: packed gaussian storage and transform state, in torch.

The counterpart of ``wgpu_3dgs_core_tpu.buffer``. A :class:`GaussiansBuffer`
holds one torch tensor per packed field, all on one device named when the
buffer is made (the card unless the caller names another). Updates write
into those tensors in place, so their storage and pointers stay fixed for
the buffer's life (a kernel bundle built with them as resources sees every
update); downloads (:func:`download`) synchronise and copy to host numpy.
:class:`GaussianTransform` keeps the reference's u32 flag packing bit for
bit; :class:`ModelTransform` hands out its TRS as tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import IntEnum

import numpy as np
import torch

from ..errors import (
    DownloadBufferError,
    FixedSizeBufferWrapperError,
    GaussiansBufferTryFromBufferError,
    GaussiansBufferUpdateError,
    GaussiansBufferUpdateRangeError,
)
from ..layouts import GaussianLayout, PackedGaussians, pack, unpack

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int8): torch.int8,
}


def _to_device(array, device) -> torch.Tensor:
    if isinstance(array, torch.Tensor):
        return array.to(device)
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def download(array: torch.Tensor) -> np.ndarray:
    """Device -> host transfer, the BufferWrapper.download analog
    (reference: src/buffer/mod.rs:27-101): waits for the work queued on a
    card, then copies. A failed transfer (a CUDA fault surfacing at the
    synchronise, a tensor without storage) raises
    :class:`DownloadBufferError`, as the reference's failed map does
    (src/error.rs:56-63)."""
    try:
        if array.is_cuda:
            torch.cuda.synchronize(array.device)
        return array.detach().cpu().numpy()
    except RuntimeError as e:
        raise DownloadBufferError(str(e)) from e


class FixedSizeBufferWrapper:
    """A tensor validated to hold exactly one POD of a known size, the
    analog of FixedSizeBufferWrapper (reference: src/buffer/mod.rs:111-150):
    construction validates the byte size; ``download_single`` pulls the
    value."""

    def __init__(self, tensor: torch.Tensor, expected_nbytes: int):
        nbytes = tensor.numel() * tensor.element_size()
        if nbytes != expected_nbytes:
            raise FixedSizeBufferWrapperError(
                buffer_size=nbytes, expected_size=expected_nbytes
            )
        self._tensor = tensor

    @property
    def buffer(self) -> torch.Tensor:
        """The wrapped tensor (the reference's Deref to wgpu::Buffer)."""
        return self._tensor

    def download_single(self) -> np.ndarray:
        """Device -> host single POD (reference: mod.rs:137-149)."""
        return download(self._tensor)


class GaussiansBuffer:
    """Device-resident packed gaussian storage
    (reference: src/buffer/gaussian.rs:13-229).

    ``data`` is a :class:`PackedGaussians` whose fields are torch tensors on
    ``device``: pos f32[N, 3], color u8[N, 4], sh (layout dtype) or None,
    cov3d (layout dtype). ``update`` / ``update_range`` keep the reference's
    count checks and write in place.
    """

    def __init__(self, packed_device: PackedGaussians,
                 device: torch.device):
        self._data = packed_device
        self.device = torch.device(device)

    @classmethod
    def new(cls, gaussians, layout: GaussianLayout = GaussianLayout(),
            device="cuda") -> "GaussiansBuffer":
        """Pack a :class:`GaussianSoA` on the host, upload to ``device``
        (reference: gaussian.rs:21-30, 61-65)."""
        return cls.new_with_packed(pack(gaussians, layout), device)

    @classmethod
    def new_with_packed(cls, packed: PackedGaussians,
                        device="cuda") -> "GaussiansBuffer":
        return cls(
            PackedGaussians(
                layout=packed.layout,
                pos=_to_device(packed.pos, device),
                color=_to_device(packed.color, device),
                sh=(None if packed.sh is None
                    else _to_device(packed.sh, device)),
                cov3d=_to_device(packed.cov3d, device),
            ),
            device,
        )

    @classmethod
    def new_empty(cls, n: int, layout: GaussianLayout = GaussianLayout(),
                  device="cuda") -> "GaussiansBuffer":
        """Zero-initialized buffer of n gaussians
        (reference: gaussian.rs:71-89)."""

        def zeros(width, dtype):
            return torch.zeros((n, width), dtype=_TORCH_DTYPES[dtype],
                               device=device)

        return cls(
            PackedGaussians(
                layout=layout,
                pos=torch.zeros((n, 3), dtype=torch.float32, device=device),
                color=torch.zeros((n, 4), dtype=torch.uint8, device=device),
                sh=(None if layout.sh_dtype is None
                    else zeros(layout.sh_width, layout.sh_dtype)),
                cov3d=zeros(layout.cov3d_width, layout.cov3d_dtype),
            ),
            device,
        )

    @classmethod
    def from_arrays(cls, layout: GaussianLayout, pos, color, sh, cov3d,
                    device="cuda") -> "GaussiansBuffer":
        """Adopt existing arrays, validating shapes against the layout
        (reference: gaussian.rs:213-229)."""
        n = pos.shape[0]
        expected = {
            "pos": (n, 3),
            "color": (n, 4),
            "cov3d": (n, layout.cov3d_width),
        }
        arrays = {"pos": pos, "color": color, "cov3d": cov3d}
        if layout.sh_dtype is not None:
            expected["sh"] = (n, layout.sh_width)
            arrays["sh"] = sh
        for name, shape in expected.items():
            arr = arrays[name]
            if arr is None or tuple(arr.shape) != shape:
                got = None if arr is None else int(np.prod(arr.shape))
                raise GaussiansBufferTryFromBufferError(
                    buffer_size=0 if got is None else got,
                    expected_multiple_size=int(np.prod(shape)),
                )
        return cls.new_with_packed(
            PackedGaussians(
                layout=layout, pos=pos, color=color,
                sh=None if layout.sh_dtype is None else sh, cov3d=cov3d,
            ),
            device,
        )

    @property
    def layout(self) -> GaussianLayout:
        return self._data.layout

    @property
    def data(self) -> PackedGaussians:
        """The device-resident packed SoA."""
        return self._data

    def __len__(self) -> int:
        return len(self._data)

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    @property
    def nbytes(self) -> int:
        return len(self) * self.layout.bytes_per_gaussian

    def update(self, gaussians) -> None:
        """Whole-buffer update, in place; counts must match
        (reference: gaussian.rs:104-137)."""
        if len(gaussians) != len(self):
            raise GaussiansBufferUpdateError(
                count=len(gaussians), expected_count=len(self)
            )
        self.update_range(0, gaussians)

    def update_range(self, start: int, gaussians) -> None:
        """Pack ``gaussians`` on the host and write them at ``start``, in
        place (``tensor[start:stop].copy_``): the buffer's tensors keep
        their storage, where the JAX package builds new arrays. The range
        must fit (reference: gaussian.rs:142-183)."""
        if start + len(gaussians) > len(self):
            raise GaussiansBufferUpdateRangeError(
                count=len(gaussians), start=start, expected_count=len(self)
            )
        packed = pack(gaussians, self.layout)
        stop = start + len(gaussians)
        d = self._data
        for name in ("pos", "color", "sh", "cov3d"):
            dst = getattr(d, name)
            if dst is not None:
                dst[start:stop].copy_(torch.from_numpy(getattr(packed, name)))

    def download_packed(self) -> PackedGaussians:
        """Device -> host packed numpy arrays
        (reference: src/buffer/mod.rs:27-101)."""
        d = self._data
        return PackedGaussians(
            layout=d.layout,
            pos=download(d.pos),
            color=download(d.color),
            sh=None if d.sh is None else download(d.sh),
            cov3d=download(d.cov3d),
        )

    def download_gaussians(self):
        """Device -> host -> canonical :class:`GaussianSoA` (reference:
        gaussian.rs:186-194). Raises IrreversibleConfigError for lossy
        layouts, where the reference panics."""
        return unpack(self.download_packed())


class GaussianDisplayMode(IntEnum):
    """(reference: gaussian_transform.rs:7-14)."""

    SPLAT = 0
    ELLIPSE = 1
    POINT = 2


def validate_sh_degree(sh_deg: int) -> int:
    """(reference: gaussian_transform.rs:21-31)."""
    if not 0 <= sh_deg <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {sh_deg}")
    return sh_deg


def quantize_max_std_dev(max_std_dev: float) -> int:
    """f32 in [0,3] -> u8, Rust `as u8` truncation
    (reference: gaussian_transform.rs:59-77)."""
    if not 0.0 <= max_std_dev <= 3.0:
        raise ValueError(
            f"max std dev must be in [0.0, 3.0], got {max_std_dev}"
        )
    return int(np.float32(max_std_dev) / np.float32(3.0) * np.float32(255.0))


@dataclass(frozen=True)
class GaussianTransform:
    """Render-time knobs (reference: GaussianTransformPod,
    gaussian_transform.rs:165-206).

    ``flags`` packs [display_mode, sh_deg, no_sh0, max_std_dev_u8] into a
    u32 exactly like the reference.
    """

    size: float = 1.0
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT
    sh_deg: int = 3
    no_sh0: bool = False
    max_std_dev: float = 3.0

    def __post_init__(self):
        validate_sh_degree(self.sh_deg)
        quantize_max_std_dev(self.max_std_dev)

    @property
    def flags(self) -> int:
        dm = int(self.display_mode) & 0xFF
        deg = self.sh_deg & 0xFF
        no0 = 1 if self.no_sh0 else 0
        std = quantize_max_std_dev(self.max_std_dev)
        return dm | (deg << 8) | (no0 << 16) | (std << 24)

    def to_pod(self) -> tuple[float, int]:
        return (float(np.float32(self.size)), self.flags)

    @classmethod
    def from_pod(cls, size: float, flags: int) -> "GaussianTransform":
        return cls(
            size=size,
            display_mode=GaussianDisplayMode(flags & 0xFF),
            sh_deg=(flags >> 8) & 0xFF,
            no_sh0=((flags >> 16) & 0xFF) != 0,
            max_std_dev=float(
                np.float32((flags >> 24) & 0xFF) / np.float32(255.0)
                * np.float32(3.0)
            ),
        )


# Flag accessors of GaussianTransform.flags, the analog of the WESL helpers
# (reference: src/shader/gaussian_transform.wesl:14-31); csrc/gaussian.cuh
# has their device counterparts. ``flags`` is an int or an integer tensor.


def gaussian_transform_display_mode(flags):
    return flags & 0xFF


def gaussian_transform_sh_deg(flags):
    return (flags >> 8) & 0xFF


def gaussian_transform_no_sh0(flags):
    return ((flags >> 16) & 0xFF) != 0


def gaussian_transform_max_std_dev(flags) -> torch.Tensor:
    return torch.as_tensor((flags >> 24) & 0xFF,
                           dtype=torch.float32) / 255.0 * 3.0


@dataclass(frozen=True)
class ModelTransform:
    """Model -> world TRS (reference: ModelTransformPod,
    model_transform.rs:60-84). Defaults to identity."""

    pos: tuple[float, float, float] = (0.0, 0.0, 0.0)
    rot: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)  # xyzw
    scale: tuple[float, float, float] = (1.0, 1.0, 1.0)

    def as_tensors(self, device) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
        return tuple(
            torch.tensor(v, dtype=torch.float32, device=device)
            for v in (self.pos, self.rot, self.scale)
        )

    def update(self, pos=None, rot=None, scale=None) -> "ModelTransform":
        """Functional update (reference: model_transform.rs:26-33)."""
        return replace(
            self,
            pos=self.pos if pos is None else tuple(pos),
            rot=self.rot if rot is None else tuple(rot),
            scale=self.scale if scale is None else tuple(scale),
        )
