"""The plain reference of the training cells: parameters, loss, Adam.

Unconstrained parameters as the program under test documents them
(means; quaternions normalised before use, with the norm floored at
1e-8; log-scales; colour and opacity through a sigmoid; SH rest bands),
the loss mean((image - target)^2) of :mod:`.render` on a black
background, and Adam written out, each step from the gradient of all six
parameters. Nothing here imports the program.
"""

from __future__ import annotations

import torch

from . import render as rr

FIELDS = ("means", "quats", "log_scales", "color_logit", "opacity_logit",
          "sh")


def initial_params(scene: dict, dtype=torch.float32) -> dict:
    """The unconstrained parameters of a drawn scene: colour and opacity
    clamped to [1e-4, 1 - 1e-4] before the logit."""
    def logit(x):
        x = torch.clamp(x, 1e-4, 1 - 1e-4)
        return torch.log(x) - torch.log1p(-x)

    p = dict(means=scene["means"], quats=scene["quats"],
             log_scales=torch.log(scene["scales"]),
             color_logit=logit(scene["colour"]),
             opacity_logit=logit(scene["opacity"]), sh=scene["sh"])
    return {k: p[k].detach().to(dtype).clone() for k in FIELDS}


def constrained(p: dict):
    """(means, Sigma [N, 3, 3], base colour, opacity, sh)."""
    norm = torch.linalg.vector_norm(p["quats"], dim=-1, keepdim=True)
    q = p["quats"] / torch.clamp_min(norm, 1e-8)
    sigma = rr.covariance(q, torch.exp(p["log_scales"]))
    return (p["means"], sigma, torch.sigmoid(p["color_logit"]),
            torch.sigmoid(p["opacity_logit"]), p["sh"])


def target_image(scene: dict, view: rr.View, dtype=torch.float32):
    """The target of ``view``: the scene's geometry with its target colour
    and SH, rendered on a black background."""
    p = initial_params(dict(scene, colour=scene["target_colour"],
                            sh=scene["target_sh"]), dtype)
    with torch.no_grad():
        means, sigma, base, op, sh = constrained(p)
        cols, depth, valid = rr.splat_columns(means, sigma, base, op, sh,
                                              view)
        img, _, _ = rr.render(cols, depth, valid, view.width, view.height)
    return img


def step_grads(p: dict, view: rr.View, target, keep_rows=None):
    """(loss, gradients of the six parameters) of one step."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    means, sigma, base, op, sh = constrained(leaves)
    cols, depth, valid = rr.splat_columns(means, sigma, base, op, sh, view)
    loss, d_cols = rr.loss_and_grad(cols, depth, valid, view.width,
                                    view.height, target,
                                    keep_rows=keep_rows)
    cols.backward(d_cols)
    return loss, {k: (leaves[k].grad if leaves[k].grad is not None
                      else torch.zeros_like(leaves[k])) for k in FIELDS}


class Adam:
    """Adam (Kingma and Ba 2015) with bias correction, one learning rate
    per parameter."""

    def __init__(self, params: dict, lrs: dict, eps: float,
                 betas=(0.9, 0.999)):
        self.lrs, self.eps, self.betas = lrs, eps, betas
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1 = 1 - b1 ** self.t
        c2 = 1 - b2 ** self.t
        for k, g in grads.items():
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            denom = torch.sqrt(self.v[k]) / (c2 ** 0.5) + self.eps
            params[k] = params[k] - (self.lrs[k] / c1) * self.m[k] / denom


def train(scene: dict, views: list, targets: list, lrs: dict, eps: float,
          steps: int, dtype=torch.float32, fault=None) -> dict:
    """``steps`` Adam steps from the scene's parameters, step k on
    ``views[k]`` against ``targets[k]``. Returns the loss of each step,
    the first step's gradient norm of each parameter, each parameter's
    change norm after the last step, and the first step's image. ``fault`` plants one of
    the control's faults: "half_rows" (the loss over the top half of the
    image, its mean taken there) or "drop_opacity_grad"."""
    p0 = initial_params(scene, dtype)
    p = {k: v.clone() for k, v in p0.items()}
    opt = Adam(p, lrs, eps)
    losses, first = [], {}
    for k in range(steps):
        rows = views[k].height // 2 if fault == "half_rows" else None
        loss, g = step_grads(p, views[k], targets[k].to(dtype),
                             keep_rows=rows)
        if fault == "drop_opacity_grad":
            g["opacity_logit"] = torch.zeros_like(g["opacity_logit"])
        losses.append(float(loss))
        if k == 0:
            first = {n: float(torch.linalg.vector_norm(v.double()))
                     for n, v in g.items()}
            with torch.no_grad():
                cols, depth, valid = rr.splat_columns(*constrained(p),
                                                      views[0])
                image = rr.render(cols, depth, valid, views[0].width,
                                  views[0].height)[0]
                del cols, depth, valid
        opt.step(p, g)
        del g
    change = {k: float(torch.linalg.vector_norm((p[k].double()
                                                 - p0[k].double())))
              for k in FIELDS}
    return dict(losses=losses, grad_norms=first, change_norms=change,
                image=image)
