"""Training: optimize gaussian parameters against a target image.

The counterpart of ``wgpu_3dgs_core_tpu.render.train``. Parameters live in
an unconstrained space (log-scales, logit colour and opacity, quaternions
that are not normalized) so plain gradient steps stay feasible;
:class:`TrainableGaussians` is an ``nn.Module`` holding them, and the
optimizer is ``torch.optim.Adam`` where the JAX package uses
``optax.adam``. Gradients come from the renderer's backward (K4-K6) and
autograd through the parameterization.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from ..models.gaussian import GaussianSoA
from ..ops.transforms import cov3d_from_rot_scale
from ..utils.profiling import named_scope
from .camera import Camera
from .renderer import measure_capacities, render

# Headroom of the capacities `fit` measures over the initial scene: room
# for the parameters to drift during the fit, as in the JAX package.
FIT_HEADROOM = 1.5
# The render knobs that change what the binning emits, and so the
# capacities `fit` measures.
MEASURE_KNOBS = ("model_transform", "size", "max_std_dev", "display_mode",
                 "antialiased")


class TrainableGaussians(nn.Module):
    """Unconstrained parameters of N gaussians, one ``nn.Parameter`` each:
    means [N, 3], quats [N, 4] (not normalized), log_scales [N, 3],
    color_logit [N, 3] (sigmoid -> base colour), opacity_logit [N]
    (sigmoid -> opacity) and sh [N, 15, 3]."""

    FIELDS = ("means", "quats", "log_scales", "color_logit", "opacity_logit",
              "sh")

    def __init__(self, means, quats, log_scales, color_logit, opacity_logit,
                 sh):
        super().__init__()
        for name, value in zip(self.FIELDS, (means, quats, log_scales,
                                             color_logit, opacity_logit, sh)):
            setattr(self, name, nn.Parameter(value.detach().float()))

    @classmethod
    def from_soa(cls, soa: GaussianSoA, device="cuda") -> "TrainableGaussians":
        """Parameters of a :class:`GaussianSoA`, on ``device``. Colour and
        opacity are clipped to [1e-4, 1 - 1e-4] so their logits are
        finite."""
        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                device)

        color = torch.clamp(t(soa.color) / 255.0, 1e-4, 1 - 1e-4)
        return cls(
            means=t(soa.pos),
            quats=t(soa.rot),
            log_scales=torch.log(t(soa.scale)),
            color_logit=torch.logit(color[:, 0:3]),
            opacity_logit=torch.logit(color[:, 3]),
            sh=t(soa.sh),
        )

    def unit_quats(self) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.quats, dim=-1, keepdim=True)
        return self.quats / torch.clamp_min(norm, 1e-8)

    def constrained(self):
        """(means, cov3d6, base_color, opacity, sh) for :func:`render`."""
        cov6 = cov3d_from_rot_scale(self.unit_quats(),
                                    torch.exp(self.log_scales))
        return (self.means, cov6, torch.sigmoid(self.color_logit),
                torch.sigmoid(self.opacity_logit), self.sh)

    @torch.no_grad()
    def to_soa(self) -> GaussianSoA:
        means, _, color, opacity, sh = self.constrained()
        rgba = torch.cat([color, opacity[:, None]], dim=-1)
        return GaussianSoA(
            rot=self.unit_quats().cpu().numpy(),
            pos=means.cpu().numpy(),
            color=torch.clamp(rgba * 255.0, 0, 255).cpu().numpy().astype(
                "uint8"),
            sh=sh.cpu().numpy(),
            scale=torch.exp(self.log_scales).cpu().numpy(),
        )


def l2_image_loss(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((image - target) ** 2)


def make_train_step(
    camera: Camera,
    target: torch.Tensor,
    optimizer: torch.optim.Optimizer,
    sh_deg: int = 3,
    background: tuple = (0.0, 0.0, 0.0),
    loss_fn=l2_image_loss,
    **render_kw: Any,
):
    """A step ``step(params) -> (loss, overflow)``: render ``params`` (the
    :class:`TrainableGaussians` whose parameters ``optimizer`` updates),
    back-propagate ``loss_fn(image, target)`` and take one optimizer step.
    ``loss`` is detached, ``overflow`` the renderer's 0-d capacity flag;
    both stay on the device.

    When ``overflow`` is set the renderer's backward zeroes the gradient
    of the rasterized attributes, so the step trains on nothing: raise
    ``max_fragments`` (or ``max_rows``, ``pad_slack``) rather than ignore
    it. :func:`fit` warns.
    """

    def step(params: TrainableGaussians):
        # The step's own time (outside its stages) is the loss and the
        # autograd backward through the attribute columns, SH, projection
        # and constrained().
        with named_scope("train.step"):
            with named_scope("train.adam"):
                optimizer.zero_grad(set_to_none=True)
            with named_scope("train.constrain"):
                means, cov6, color, opacity, sh = params.constrained()
            res = render(means, cov6, color, opacity, camera, sh=sh,
                         sh_deg=sh_deg, background=background, **render_kw)
            loss = loss_fn(res.image, target)
            loss.backward()
            with named_scope("train.adam"):
                optimizer.step()
            return loss.detach(), res.overflow

    return step


def fit(
    initial: GaussianSoA,
    camera: Camera,
    target,
    steps: int = 200,
    learning_rate: float = 5e-3,
    optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None,
    log_every: int = 0,
    device=None,
    **kw: Any,
) -> tuple[GaussianSoA, list[float]]:
    """Fit a scene to one target image [H, W, 3]. Returns (fitted scene,
    loss curve).

    Runs on ``target``'s device when it is a tensor, else on ``device``
    (the card by default). ``optimizer`` makes the optimizer from the
    parameters (default ``torch.optim.Adam`` at ``learning_rate``). Unless
    ``max_fragments`` is passed, the capacities are measured from the
    initial scene with FIT_HEADROOM for parameter drift. The curve holds
    every ``log_every``-th step's loss (when > 0) and always the last
    step's; ``steps == 0`` gives an empty curve.
    """
    if isinstance(target, torch.Tensor):
        device = target.device
    device = torch.device(device or "cuda")
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    params = TrainableGaussians.from_soa(initial, device)
    make_opt = optimizer or (lambda p: torch.optim.Adam(p, lr=learning_rate))
    opt = make_opt(params.parameters())
    if "max_fragments" not in kw:
        means, cov6, _, opacity, _ = params.constrained()
        knobs = {k: kw[k] for k in MEASURE_KNOBS if k in kw}
        max_fragments, max_rows = measure_capacities(
            means, cov6, opacity, camera, headroom=FIT_HEADROOM, **knobs)
        kw["max_fragments"] = max_fragments
        kw.setdefault("max_rows", max_rows)
    step = make_train_step(camera, target, opt, **kw)

    losses: list[float] = []
    warned = False
    for i in range(steps):
        loss, overflow = step(params)
        if (log_every and i % log_every == 0) or i == steps - 1:
            # Sync only on logged steps.
            losses.append(float(loss))
            if not warned and bool(overflow):
                warnings.warn(
                    "fragment capacity overflow: gradients are zeroed and "
                    "the overflowing steps optimized nothing; raise "
                    "max_fragments",
                    RuntimeWarning,
                    stacklevel=2,
                )
                warned = True
    return params.to_soa(), losses
