"""The frozen work model: operations and bytes that a frame or a training
step needs, from counts of the cell's inputs.

The counts come from the benchmark's plain reference
(``reference/render.py::Counts``): gaussians N, visible splats V,
gaussians with a kept pair U, (gaussian, tile) fragments with a kept
pair F, blended (pixel, gaussian) pairs B, pixels P. None of them reads
a counter, capacity or cull of the program, so a redesign of the
program's binning or culling leaves the yardstick as it is.

Operations are float32 additions, multiplications and comparisons that
feed a value, an FMA counted as two, exp and sqrt and a division as one
each: the least that the arithmetic written below needs, so that a share
of the peak is a lower bound. Bytes count each input read once and each
output written once.

Peaks: NVIDIA H100 SXM data sheet, dense float32 outside the tensor
cores and HBM3 bandwidth.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# --- per blended (pixel, gaussian) pair
# Forward (bounds K3): dx, dy (2); dx^2, dx dy, dy^2 (3); a., 2b., c.
# (3); two sums (2); -q/2 (1); exp (1); opacity times it (1): alpha, 13.
# Blend: alpha T (1), three colour FMAs (6), T (1 - alpha) (2): 9.
FWD_PAIR_FLOPS = 22
# Backward (bounds K4): alpha again (13); T_i from T_{i+1} (2); the
# colour gradient, weight times dL/dpixel (3); dL/dalpha from the colour
# and the light behind (8); through the clamp and exp to the opacity and
# q (2); q's gradient to a, b, c (3) and to x, y (8); nine sums (9): 48,
# of which 44 are counted (the clamp's test and the sums of the light
# behind may fold into others).
BWD_PAIR_FLOPS = 44

# --- bytes of the rasterizer
GAUSS_COLUMNS_B = 36  # x, y, conic a b c, r g b, opacity: 9 f32
FRAG_INDEX_B = 4      # one gaussian index per fragment
PIXEL_OUT_B = 16      # rgb + transmittance f32
PIXEL_GRAD_B = 12     # dL/drgb f32
# --- segment sums: per-fragment gradients in, per-gaussian sums out
FRAG_GRAD_B = 36

# --- per gaussian, outside the rasterizer (float32 operations)
# Projection forward, for every gaussian (the cull needs it): camera
# point 15, depth clamps and ratios 4, Jacobian 6, J W 30, (J W) Sigma
# (J W)^T 45, low-pass 2, determinant 3, conic 3, pixel position 6: 114.
PROJECT_FWD = 114
# Its backward, for visible splats: twice the forward.
PROJECT_BWD = 228
# SH colour forward, visible splats: direction 12, basis 30, 45 FMAs
# 90, base and clamp 6: 138; backward: 45 products for dsh, the basis'
# gradient to the direction 60, the direction's to the mean 20: 125.
SH_FWD = 138
SH_BWD = 125
# constrained(): quaternion norm 12, exp 3, R 30, R diag(s) 9, Sigma 30,
# sigmoids 16: 100; backward 200.
CONSTRAIN_FWD = 100
CONSTRAIN_BWD = 200
# Adam per parameter element: moments 7, bias-corrected step 6: 13; 59
# elements a gaussian (3 + 4 + 3 + 3 + 1 + 45).
ADAM_ELEM = 13
PARAM_ELEMS = 59
# Unpacking a packed gaussian: colour and opacity over 255 (4).
UNPACK = 4
# Loss per pixel: three differences, squares and sums (9); its gradient
# (6).
LOSS_PIXEL = 15


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time: the larger of operations over the peak and bytes
    over the bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def k3(c) -> tuple[float, float]:
    """(flops, bytes) of the forward blend of one frame."""
    return (FWD_PAIR_FLOPS * c.blended,
            GAUSS_COLUMNS_B * c.used + FRAG_INDEX_B * c.fragments
            + PIXEL_OUT_B * c.pixels)


def k4(c) -> tuple[float, float]:
    """(flops, bytes) of the blend's backward: columns and fragment
    indices in, the forward's pixels and dL/dpixel in, per-gaussian
    gradients out."""
    return (BWD_PAIR_FLOPS * c.blended,
            2 * GAUSS_COLUMNS_B * c.used + FRAG_INDEX_B * c.fragments
            + (PIXEL_OUT_B + PIXEL_GRAD_B) * c.pixels)


def segsum(c) -> tuple[float, float]:
    """(flops, bytes) of summing per-fragment gradients per gaussian, out
    in gaussian order: nine sums a fragment."""
    return (9 * c.fragments,
            (FRAG_GRAD_B + FRAG_INDEX_B) * c.fragments
            + GAUSS_COLUMNS_B * c.gaussians)


def train_step_flops(c) -> float:
    """Operations of one training step."""
    return (c.gaussians * (CONSTRAIN_FWD + CONSTRAIN_BWD + PROJECT_FWD
                           + ADAM_ELEM * PARAM_ELEMS)
            + c.visible * (PROJECT_BWD + SH_FWD + SH_BWD)
            + (FWD_PAIR_FLOPS + BWD_PAIR_FLOPS) * c.blended
            + 9 * c.fragments + LOSS_PIXEL * c.pixels)


def frame_flops(c) -> float:
    """Operations of one viewer frame from a packed scene."""
    return (c.gaussians * (UNPACK + PROJECT_FWD) + c.visible * SH_FWD
            + FWD_PAIR_FLOPS * c.blended)


def roofline_pct(work, device_s: float):
    """100 x the least time of ``work`` [(flops, bytes), ...] over the
    device time it took; None where nothing was timed."""
    if device_s <= 0 or not work:
        return None
    least = least_seconds(sum(w[0] for w in work), sum(w[1] for w in work))
    return 100.0 * least / device_s
