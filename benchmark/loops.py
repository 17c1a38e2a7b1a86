"""The general generator: the two closed loops a traffic file selects.

A traffic file (``traffic/<mix>.json``) names its loop (``"loop"``) and
gives its parameters; a new mix of either kind is a new data file.

- ``train``: training steps of the port's ``make_train_step`` on a
  ``TrainableGaussians`` with ``torch.optim.Adam``, one view a step,
  visiting seeded views in a seeded permutation each epoch, against
  targets the port renders at set-up from the same geometry with colour
  and SH drawn again. Each step ends by reading its overflow flag, as a
  training loop that logs its loss every step does.
- ``view``: frames of the port's ``render_gaussians`` on a
  ``GaussiansBuffer`` in a packed layout, along a camera path that sweeps
  the ring's azimuth back and forth by a fixed step a frame, each frame
  synchronised.

Each loop builds its inputs from the seed, warms up, then serves
``iterate`` calls. After the window, ``after_window`` runs the traced
block where one is asked for and, for training, the checked steps from
the seed's draw; then the loop frees the program's state and compares
what the timed path produced with the plain reference.
"""

from __future__ import annotations

import math
import random
import time

import torch

from . import scene as sc
from .reference import render as rr
from .reference import train as rt

# The port, imported on first use so that importing this module needs
# no program.
_PORT = {}


def port():
    if not _PORT:
        import wgpu_3dgs_core_tpu_torch as gt
        from wgpu_3dgs_core_tpu_torch.render import renderer, train

        _PORT.update(gt=gt, renderer=renderer, train=train)
    return _PORT


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rel_gap(a: float, b: float, floor: float) -> float:
    """|a - b| / max(|b|, floor)."""
    return abs(a - b) / max(abs(b), floor)


class Loop:
    """What both loops share: the set-up clock and the reference's
    precision."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.setup_split: dict = {}
        # Steps or frames outside the window that overflowed.
        self.overflowed = 0
        self.drift: list = []

    def start_window(self) -> None:
        """Called once before the measured window."""

    def after_window(self, traced_block=None):
        """Called once after the window: runs ``traced_block(iterate)``
        where given and returns its trace."""
        return None if traced_block is None else traced_block(self.iterate)

    def phase(self, name: str, t0: float) -> float:
        sync(self.device)
        t1 = time.perf_counter()
        self.setup_split[name] = self.setup_split.get(name, 0.0) + t1 - t0
        return t1


class TrainLoop(Loop):
    """Closed loop of training steps (see the module's docstring)."""

    kind = "train"

    def views(self) -> list:
        """The ring's views, the same for every seed: azimuths evenly
        over [-a, a], elevations evenly over [-e, e] in a shuffled but
        fixed order. The seed orders the visits."""
        t = self.traffic
        n = int(t["views"])
        a, e = float(t["azimuth_deg"]), float(t["elevation_deg"])
        step = 7 if n % 7 else 1
        return [sc.orbit_view(self.cfg, t, -a + 2 * a * k / max(n - 1, 1),
                              -e + 2 * e * ((k * step) % n) / max(n - 1, 1))
                for k in range(n)]

    def schedule(self):
        """View indices: a seeded permutation each epoch, the same
        sequence from each call."""
        gen = torch.Generator().manual_seed(self.seed % (1 << 63))
        while True:
            for v in torch.randperm(len(self.ref_views),
                                    generator=gen).tolist():
                yield v

    def lrs(self) -> dict:
        lr = self.traffic["lr"]
        # 3DGS scales the means' rate by the cameras' extent: 1.1 times
        # the largest distance of a camera centre from their mean.
        cams = torch.stack([rr.camera_centre(v, "cpu", torch.float64)
                            for v in self.ref_views])
        extent = 1.1 * float(torch.linalg.vector_norm(
            cams - cams.mean(0), dim=-1).max())
        return dict(means=lr["means"] * extent, quats=lr["quats"],
                    log_scales=lr["log_scales"],
                    color_logit=lr["color_logit"],
                    opacity_logit=lr["opacity_logit"], sh=lr["sh"])

    def setup(self) -> None:
        P = port()
        dev = self.device
        t0 = time.perf_counter()
        scene = sc.draw_scene(self.cfg, self.seed, dev)
        self.ref_views = self.views()
        self.cams = [sc.port_camera(v) for v in self.ref_views]
        init = rt.initial_params(scene)
        self.params = P["train"].TrainableGaussians(**init)
        tgt = P["train"].TrainableGaussians(**rt.initial_params(dict(
            scene, colour=scene["target_colour"], sh=scene["target_sh"])))
        del scene, init
        t0 = self.phase("scene", t0)

        mf = mr = 0
        with torch.no_grad():
            means, cov6, _, op, _ = self.params.constrained()
            for cam in self.cams:
                f, r = P["renderer"].measure_capacities(
                    means, cov6, op, cam, headroom=P["train"].FIT_HEADROOM)
                mf, mr = max(mf, f), max(mr, r)
            del means, cov6, op
        self.capacities = (mf, mr)
        t0 = self.phase("capacities", t0)

        self.render_kw = dict(sh_deg=int(self.cfg["sh_degree"]),
                              max_fragments=mf, max_rows=mr)
        self.targets = []
        with torch.no_grad():
            means, cov6, color, op, sh = tgt.constrained()
            for cam in self.cams:
                res = P["renderer"].render(means, cov6, color, op, cam,
                                           sh=sh, **self.render_kw)
                self.overflowed += int(bool(res.overflow))
                self.targets.append(res.image)
            del means, cov6, color, op, sh, tgt
        t0 = self.phase("targets", t0)

        groups = [{"params": [getattr(self.params, k)], "lr": v, "name": k}
                  for k, v in self.lrs().items()]
        self.opt = torch.optim.Adam(groups, eps=self.traffic["adam_eps"])
        self.keep_image = False
        self.kept_image = None
        self.steps = [
            P["train"].make_train_step(cam, tgt_img, self.opt,
                                       loss_fn=self.loss_fn,
                                       **self.render_kw)
            for cam, tgt_img in zip(self.cams, self.targets)]
        self.order = self.schedule()
        self.drift = [self.drawn_fragments()]
        for k in range(int(self.traffic["warmup_steps"])):
            self.iterate(k)
            self.overflowed += int(not self.last_ok)
            if k == 0:
                t0 = self.phase("first_step", t0)
        self.phase("warmup", t0)

    def loss_fn(self, image, target):
        """The port's loss; the checked run's first step keeps its
        image."""
        if self.keep_image:
            self.kept_image = image.detach().clone()
            self.keep_image = False
        return port()["train"].l2_image_loss(image, target)

    @torch.no_grad()
    def reset(self) -> None:
        """The parameters back to the seed's draw, in place, and Adam's
        state cleared; the same step objects and optimizer serve on."""
        scene = sc.draw_scene(self.cfg, self.seed, self.device)
        init = rt.initial_params(scene)
        del scene
        for k in rt.FIELDS:
            getattr(self.params, k).copy_(init[k])
        del init
        self.opt.zero_grad(set_to_none=True)
        self.opt.state.clear()

    def after_window(self, traced_block=None):
        """After the window: the drift record, then (for ``--trace 1``)
        the traced block from the seed's draw, so that the work counted
        from the inputs is the work traced; then the checked steps, again
        from the draw, through the window's own step objects and
        optimizer, which the reference follows."""
        self.drift.append(self.drawn_fragments())
        traced = None
        if traced_block is not None:
            self.reset()
            traced = traced_block(self.iterate)
            self.drift.append(self.drawn_fragments())
        self.reset()
        self.order = self.schedule()
        self.checked_views = []
        self.prog_losses, self.prog_grad_norms = [], {}
        p0 = {k: getattr(self.params, k).detach().clone()
              for k in rt.FIELDS}
        for k in range(int(self.traffic["checked_steps"])):
            v = next(self.order)
            self.keep_image = k == 0
            loss, ovf = self.steps[v](self.params)
            self.overflowed += int(bool(ovf))
            self.checked_views.append(v)
            self.prog_losses.append(float(loss))
            if k == 0:
                self.prog_grad_norms = self.first_grad_norms()
        self.prog_change_norms = {
            k: float(torch.linalg.vector_norm(
                getattr(self.params, k).detach().double() - p0[k].double()))
            for k in rt.FIELDS}
        del p0
        return traced

    def first_grad_norms(self) -> dict:
        """Each parameter's first gradient as Adam holds it: its first
        moment over (1 - beta1)."""
        out = {}
        for g in self.opt.param_groups:
            p = g["params"][0]
            st = self.opt.state.get(p, {})
            m = st.get("exp_avg")
            out[g["name"]] = (0.0 if m is None else float(
                torch.linalg.vector_norm(m.double())) / (1 - g["betas"][0]))
        return out

    def iterate(self, k: int):
        v = next(self.order)
        _, ovf = self.steps[v](self.params)
        self.last_ok = not bool(ovf)
        return v

    @torch.no_grad()
    def drawn_fragments(self) -> int:
        """The port's count of the fragments it draws for the first view
        at the current parameters (a record of the fit's drift, no
        input of any metric)."""
        means, cov6, _, op, _ = self.params.constrained()
        return port()["renderer"].measure_capacities(
            means, cov6, op, self.cams[0], headroom=1.0)[0]

    def release(self) -> None:
        for name in ("params", "opt", "steps", "targets"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The reference's three steps against the program's: each step's
        loss, the first gradient and the change after the last step, by
        the worst parameter (see ``gaps``)."""
        rr.plain_precision()
        scene = sc.draw_scene(self.cfg, self.seed, self.device)
        views = [self.ref_views[v] for v in self.checked_views]
        targets = [rt.target_image(scene, v) for v in views]
        ref = rt.train(scene, views, targets, self.lrs(),
                       self.traffic["adam_eps"], len(views))
        del scene, targets
        return gaps(dict(losses=self.prog_losses,
                         grad_norms=self.prog_grad_norms,
                         change_norms=self.prog_change_norms,
                         image=self.kept_image), ref)

    def inputs(self, dtype=torch.float32):
        """The reference's inputs (means, Sigma, base colour, opacity,
        sh): the drawn scene's parameters, constrained."""
        scene = sc.draw_scene(self.cfg, self.seed, self.device)
        p = rt.initial_params(scene, dtype)
        del scene
        with torch.no_grad():
            return rt.constrained(p)


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers a training cell compares.

    - ``loss_gap``: the largest |loss - reference| / reference over the
      checked steps.
    - ``grad_gap``: over the parameters, the largest gap between the
      program's and the reference's first-gradient norm, over the
      reference's norm of that parameter or the median parameter's,
      whichever is larger.
    - ``update_gap``: the same of each parameter's change over the
      checked steps, leaving out parameters whose reference gradient is
      under a thousandth of the median parameter's (round-off moves them
      under Adam).
    - ``image_gap``: the relative L2 gap of the first checked step's
      rendered image, where the reference gives one."""
    rg = ref["grad_norms"]
    med_g = sorted(rg.values())[len(rg) // 2]
    rc = ref["change_norms"]
    med_c = sorted(rc.values())[len(rc) // 2]
    loss = max(rel_gap(a, b, 1e-30) for a, b in
               zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    grad = max(rel_gap(prog["grad_norms"].get(k, 0.0), rg[k],
                       max(med_g, 1e-30)) for k in rg)
    moved = [k for k in rc if rg[k] >= 1e-3 * med_g]
    update = max(rel_gap(prog["change_norms"].get(k, 0.0), rc[k],
                         max(med_c, 1e-30)) for k in moved)
    out = dict(loss_gap=loss, grad_gap=grad, update_gap=update)
    if "image" in ref:
        img = prog.get("image")
        out["image_gap"] = (math.inf if img is None
                            else rel_l2(img, ref["image"]))
    return out


class ViewLoop(Loop):
    """Closed loop of viewer frames (see the module's docstring)."""

    kind = "view"

    def path(self):
        """Azimuths (degrees) of the sweep and the seeded start: a phase
        along the back-and-forth sweep."""
        t = self.traffic
        step, lim = float(t["step_deg"]), float(t["azimuth_deg"])
        n = int(round(2 * lim / step)) + 1
        self.azimuths = [-lim + i * step for i in range(n)]
        period = 2 * (n - 1)
        self.start = random.Random(self.seed).randrange(period)
        self.period = period

    def frame_view(self, i: int) -> int:
        k = (self.start + i) % self.period
        n = len(self.azimuths)
        return k if k < n else self.period - k

    def layout(self):
        gt = port()["gt"]
        lay = self.traffic["layout"]
        return gt.GaussianLayout(sh=gt.ShFormat(lay["sh"]),
                                 cov3d=gt.Cov3dFormat(lay["cov3d"]))

    def setup(self) -> None:
        P = port()
        gt = P["gt"]
        dev = self.device
        t0 = time.perf_counter()
        scene = sc.draw_scene(self.cfg, self.seed, dev)
        soa = gt.GaussianSoA(**soa_arrays(scene))
        del scene
        t0 = self.phase("scene", t0)
        self.buffer = gt.GaussiansBuffer.new(soa, layout=self.layout(),
                                             device=dev)
        del soa
        t0 = self.phase("pack_upload", t0)
        self.path()
        t = self.traffic
        self.ref_views = [sc.orbit_view(self.cfg, t, a,
                                        float(t["elevation_deg"]))
                          for a in self.azimuths]
        self.cams = [sc.port_camera(v) for v in self.ref_views]
        mf = mr = 0
        with torch.no_grad():
            means, cov6, _, op, _ = P["renderer"].unpack_gaussians(
                self.buffer.data)
            for cam in self.cams:
                f, r = P["renderer"].measure_capacities(means, cov6, op, cam)
                mf, mr = max(mf, f), max(mr, r)
            del means, cov6, op
        self.capacities = (mf, mr)
        self.transform = gt.GaussianTransform(sh_deg=int(self.cfg["sh_degree"]))
        t0 = self.phase("capacities", t0)
        self.frame_ms = []
        self.samples = []
        self.keep = int(t["sample_frames"])
        self._rng = random.Random(self.seed)
        self._prev = None
        self._frame = 0
        for _ in range(int(t["warmup_frames"])):
            self.render(self._frame % len(self.cams))
        self.phase("warmup", t0)

    def render(self, v: int):
        return port()["renderer"].render_gaussians(
            self.buffer, self.cams[v], transform=self.transform,
            max_fragments=self.capacities[0], max_rows=self.capacities[1])

    def iterate(self, k: int):
        """One frame: its time from its start to its end on the device."""
        i = self._frame
        self._frame += 1
        v = self.frame_view(i)
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        res = self.render(v)
        if cuda:
            end.record()
        self.last_ok = not bool(res.overflow)
        self.frame_ms.append(start.elapsed_time(end) if cuda
                             else (time.perf_counter() - t0) * 1e3)
        # A seeded reservoir sample of the frames, kept for the check.
        if len(self.samples) < self.keep:
            slot = len(self.samples)
            self.samples.append(None)
        else:
            j = self._rng.randrange(i + 1)
            slot = j if j < self.keep else None
        if slot is not None:
            self.samples[slot] = (v, res.image.clone(),
                                  res.transmittance.clone())
        return v

    def start_window(self) -> None:
        self.frame_ms = []
        self.samples = []
        self._frame = 0
        self._rng = random.Random(self.seed)

    def release(self) -> None:
        self.buffer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The sampled frames against the reference's render of the same
        views: the relative L2 gap of the image and of the
        transmittance, the largest over the samples."""
        rr.plain_precision()
        means, sigma, base, op, sh = self.inputs()
        image = trans = 0.0
        for v, img, tr in self.samples:
            view = self.ref_views[v]
            cols, depth, valid = rr.splat_columns(means, sigma, base, op, sh,
                                                  view)
            ref_img, ref_tr, _ = rr.render(cols, depth, valid, view.width,
                                           view.height)
            image = max(image, rel_l2(img, ref_img))
            trans = max(trans, rel_l2(tr, ref_tr))
        if not self.samples:
            image = trans = math.inf
        return dict(image_gap=image, trans_gap=trans)

    def inputs(self, dtype=torch.float32):
        """The reference's inputs: the drawn scene as the packed layout
        holds it, worked out again (covariance from rotation and scale,
        rounded to the layout's dtype; SH rounded likewise; colour and
        opacity from their bytes)."""
        scene = sc.draw_scene(self.cfg, self.seed, self.device)
        arr = soa_tensors(scene)
        del scene
        lay = self.traffic["layout"]
        with torch.no_grad():
            sigma = rr.covariance(arr["rot"], arr["scale"])
            if lay["cov3d"] == "cov3d_half":
                sigma = rr.full_sigma(rr.sigma6(sigma).half().float())
            sh = arr["sh"]
            if lay["sh"] == "sh_half":
                sh = sh.half().float()
            rgba = arr["color"].float() / 255.0
        return (arr["pos"].to(dtype), sigma.to(dtype), rgba[:, :3].to(dtype),
                rgba[:, 3].to(dtype), sh.to(dtype))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double().to(a.device)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp_min(torch.linalg.vector_norm(b), 1e-30))


def soa_tensors(scene: dict) -> dict:
    """The SoA a viewer loads, on the scene's device: rotation, position,
    colour and opacity as bytes (rounded), SH, scale."""
    rgba = torch.cat([scene["colour"], scene["opacity"][:, None]], dim=1)
    color = torch.clamp(torch.round(rgba * 255.0), 0, 255).to(torch.uint8)
    return dict(rot=scene["quats"], pos=scene["means"], color=color,
                sh=scene["sh"], scale=scene["scales"])


def soa_arrays(scene: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in soa_tensors(scene).items()}


LOOPS = {"train": TrainLoop, "view": ViewLoop}
