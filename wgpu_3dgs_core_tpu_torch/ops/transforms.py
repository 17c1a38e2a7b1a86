"""Device math library: quaternion, covariance and packed-field unpacking.

The counterpart of ``wgpu_3dgs_core_tpu.ops.transforms`` in torch, batched
over leading axes. 3x3 matrices of per-gaussian values are nested lists of
tensors (or Python floats, for constant matrices): products are written
out elementwise in index order, the same on every device, and a constant
matrix never has to be copied to the device.
"""

from __future__ import annotations

import torch


def split_last(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The last axis of ``x`` as contiguous tensors (one copy), so the
    elementwise math below runs on dense rows instead of strided views."""
    return tuple(x.movedim(-1, 0).contiguous())


def device_constant(values, device) -> torch.Tensor:
    """A small f32 tensor of Python floats, written on ``device`` by fills:
    no host-to-device copy, so building it never waits on the device."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i] = v
    return out


def quat_rows(q: torch.Tensor) -> list[list[torch.Tensor]]:
    """Rotation matrix of unit quaternions q [..., 4] (xyzw) as a nested
    3x3 list of [...] tensors: element for element the expansion of the
    shaders (reference: src/shader/gaussian.wesl:84-118; glam
    Mat3::from_quat)."""
    x, y, z, w = split_last(q)
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return [
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ]


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (xyzw, normalized) -> rotation matrix [..., 3, 3]."""
    return torch.stack([torch.stack(r, dim=-1) for r in quat_rows(q)],
                       dim=-2)


def mat3_mul(a, b):
    """a @ b for 3x3 nested sequences whose entries are tensors or Python
    floats, summed in index order."""
    return [
        [a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
         for j in range(3)]
        for i in range(3)
    ]


def transpose3(a):
    return [[a[j][i] for j in range(3)] for i in range(3)]


# (row, column) of the packed upper-triangular sigma6 entries.
SIGMA6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def cov3d_from_rot_scale(rot: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """(quat [...,4], scale [...,3]) -> upper-triangular sigma [...,6].

    Sigma = M M^T with M = R diag(s), packed (xx, xy, xz, yy, yz, zz)
    (reference: src/gaussian_config.rs:195-209).
    """
    r = quat_rows(rot)
    s = split_last(scale)
    m = [[r[i][j] * s[j] for j in range(3)] for i in range(3)]
    return torch.stack(
        [m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]
         for i, j in SIGMA6],
        dim=-1,
    )


def sigma6_rows(sigma6: torch.Tensor) -> list[list[torch.Tensor]]:
    """Packed upper-triangular [...,6] -> symmetric nested 3x3 list."""
    xx, xy, xz, yy, yz, zz = split_last(sigma6)
    return [[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]]


def sigma6_to_mat3(sigma6: torch.Tensor) -> torch.Tensor:
    """Packed upper-triangular [...,6] -> symmetric matrix [...,3,3]."""
    xx, xy, xz, yy, yz, zz = (sigma6[..., i] for i in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def unpack_cov3d(cov3d: torch.Tensor, rot_scale: bool) -> torch.Tensor:
    """Packed cov3d (f32 quat+scale, or f32/f16 sigma6) -> f32 [...,6]
    (reference: src/shader/gaussian.wesl:80-149)."""
    cov3d = cov3d.float()
    if rot_scale:
        return cov3d_from_rot_scale(cov3d[..., 0:4], cov3d[..., 4:7])
    return cov3d[..., 0:6]


def unpack_sh(sh: torch.Tensor | None, n: int,
              device="cuda") -> torch.Tensor:
    """Packed SH -> f32 [..., 15, 3]: f32 passthrough, f16 cast, int8
    snorm (v/127 floored at -1), None -> zeros on ``device``
    (reference: src/shader/gaussian.wesl:29-77)."""
    if sh is None:
        return torch.zeros((n, 15, 3), dtype=torch.float32, device=device)
    if sh.dtype == torch.int8:
        vals = torch.clamp_min(sh[..., :45].float() / 127.0, -1.0)
    else:
        vals = sh[..., :45].float()
    return vals.reshape(*sh.shape[:-1], 15, 3)


def unpack_color(color: torch.Tensor) -> torch.Tensor:
    """u8 [...,4] RGBA -> f32 [...,4] in [0,1]
    (reference: src/shader/gaussian.wesl:24-26)."""
    return color.float() / 255.0
