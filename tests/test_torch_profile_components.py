"""The port's attribution tools (``tools/profile_components.py``,
``bench_bin``, ``bench_bwd``, ``bench_nscale``) on the CPU, the kernels
through their plain versions, on the port bench's scene at 2,000
gaussians, 160x96, sh_deg 3.

Each stage must compute what the step computes: every prefix stage of
``profile_components`` gives the matching pieces of one ``render`` call
of the bench step bit for bit (its functions recorded as the step calls
them), the ``fwd`` stage its loss, the ``step`` stage its gradients;
``bench_bin``'s last stage gives ``bin_splats_attrs`` then
``pad_schedule`` bit for bit and each of its stages the pieces of the
last; ``reorder`` gives
``BinRasterize.backward``'s gradient columns bit for bit; ``nscale``'s
gradients are within 1e-5 (normalized by each parameter's largest) of
``jax.grad`` of the same table loss through the JAX ``project`` and
``gaussian_color`` (jnp, no Pallas). Every tool's ``main`` raises on a
CPU device: the tools read device time on a card only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_core_tpu import Camera as JCamera
from wgpu_3dgs_core_tpu.ops.projection import project as jax_project
from wgpu_3dgs_core_tpu.ops.sh import gaussian_color as jax_color
from wgpu_3dgs_core_tpu_torch import bench as pb
from wgpu_3dgs_core_tpu_torch.ops.binning import (
    bin_splats_attrs,
    num_tiles,
    pad_schedule,
    padded_capacity,
)
from wgpu_3dgs_core_tpu_torch.render import renderer as TRR
from wgpu_3dgs_core_tpu_torch.render.renderer import measure_capacities
from wgpu_3dgs_core_tpu_torch.tools import (
    bench_bin,
    bench_bwd,
    bench_nscale,
    profile_components as pc,
)
from wgpu_3dgs_core_tpu_torch.tools.stages import (
    FORWARD_PREFIX,
    stream_capacity,
)

from .torch_parity import nn, one_torch_thread  # noqa: F401

N, W, H = 2000, 160, 96
PAD_SLACK, SH_DEG = 0.65, 3
NSCALE_TOL = 1e-5  # normalized by each parameter's largest gradient
# The renderer's functions recorded as the step calls them.
RECORDED = ("project_splats", "sh_color", "attribute_columns",
            "bin_splats_attrs", "pad_schedule", "rasterize_tiles_fwd",
            "reorder_grads")


def _same(a, b, what):
    """Bit for bit: tensors, and tuples of them field by field."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), what
    else:
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")


@pytest.fixture(scope="module")
def setup():
    scene = pb.synthetic_scene(N, device="cpu")
    cam = pb.bench_camera(W, H)
    caps = measure_capacities(scene[0], scene[1], scene[3], cam)
    return pb.leaves(scene), cam, caps


@pytest.fixture(scope="module")
def recorded_step(setup):
    """One bench step on the CPU with the renderer's functions recorded:
    (the step's (loss, overflow, grads), {function name: its output})."""
    params, cam, (max_fragments, max_rows) = setup
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in RECORDED:
            def record(*args, _fn=getattr(TRR, name), _name=name, **kw):
                seen[_name] = _fn(*args, **kw)
                return seen[_name]
            mp.setattr(TRR, name, record)
        step, _ = pb.make_step(cam, max_fragments, max_rows, PAD_SLACK,
                               SH_DEG)
        out = step(params)
    assert not bool(out[1])
    return out, seen


@pytest.fixture(scope="module")
def tool_stages(setup):
    params, cam, (max_fragments, max_rows) = setup
    return pc.stages(params, cam, max_fragments, max_rows, PAD_SLACK,
                     SH_DEG)


@pytest.mark.parametrize("stage", FORWARD_PREFIX)
def test_prefix_stage_is_render_pieces(tool_stages, recorded_step, stage):
    """Each prefix stage's pieces are those of the step's render call."""
    _, seen = recorded_step
    out = tool_stages[stage]()
    _same((out["splats"], out["opacity"]), seen["project_splats"],
          "project_splats")
    if stage == "project":
        return
    _same(out["rgb"], seen["sh_color"], "rgb")
    _same(out["attr_cols"], seen["attribute_columns"].detach(), "attr_cols")
    if stage == "color":
        return
    assert not bool(out["overflow"])
    _same((out["stream"], out["frags"], out["table"]),
          seen["bin_splats_attrs"], "bin_splats_attrs")
    if stage == "bin":
        return
    _same(out["sched"], seen["pad_schedule"], "pad_schedule")
    if stage == "sched":
        return
    _same(out["tiles"], seen["rasterize_tiles_fwd"], "K3 tiles")
    _same(tool_stages["kernel_fwd"](), seen["rasterize_tiles_fwd"],
          "kernel_fwd")


def test_fwd_and_step_stages_are_the_bench_step(tool_stages,
                                                recorded_step):
    """fwd gives the step's loss; step its loss and gradients, those of
    render's autograd, bit for bit."""
    (loss, _, grads), _ = recorded_step
    fwd = tool_stages["fwd"]()
    assert torch.equal(fwd["loss"], loss) and not bool(fwd["overflow"])
    out = tool_stages["step"]()
    assert torch.equal(out["loss"], loss) and not bool(out["overflow"])
    _same(out["grads"], grads, "grads")
    dfrag = tool_stages["kernel_fwd_bwd"]()
    assert dfrag.shape[0] == 9 and torch.isfinite(dfrag).all()


def test_reorder_is_bin_rasterize_backward(tool_stages, recorded_step):
    """reorder, on the tail inputs the tool makes from one forward, gives
    the gradient columns BinRasterize.backward gave in the step."""
    _, seen = recorded_step
    got = tool_stages["reorder"]()
    _same(got, seen["reorder_grads"], "d_cols")
    assert got.abs().max() > 0


def test_bench_bin_stages_are_bin_splats_attrs(setup):
    """The last stage is bin_splats_attrs then pad_schedule bit for bit;
    every stage's pieces are the last stage's."""
    params, cam, (max_fragments, max_rows) = setup
    st = bench_bin.stages(params, cam, max_fragments, max_rows, PAD_SLACK,
                          SH_DEG)
    outs = {name: fn() for name, fn in st.items()}
    proj = bench_bin.projection(params, cam, SH_DEG)
    tx, ty = num_tiles(W, H)
    f_cap = stream_capacity(max_fragments)
    stream, frags, table = bin_splats_attrs(
        *(proj[k] for k in ("xy", "extent", "depth", "mask", "attr_cols")),
        tx, ty, f_cap, max_rows=max_rows)
    sched = pad_schedule(stream, padded_capacity(f_cap, tx * ty, PAD_SLACK))
    last = outs["ranges"]
    _same((last["stream"], last["frags"], last["table"],
           last["sched"]), (stream, frags, table, sched), "ranges")
    assert not bool(last["overflow"])
    for name, out in outs.items():
        if name == "counts":
            _same(out["row_counts"].sum(dtype=torch.int32),
                  last["total_rows"], "counts")
            continue
        for key, piece in out.items():
            _same(piece, last[key], f"{name}.{key}")


def test_nscale_matches_jax_grad(setup):
    """nscale's gradients against jax.grad of sum(table * 1e-6) through
    the JAX project and gaussian_color, on the same inputs."""
    params, cam, _ = setup
    got = bench_bwd.nscale(params, cam, SH_DEG)
    jcam = JCamera.look_at(eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
                           width=W, height=H, fov_y=0.9)

    def loss(means, cov6, color, opac, sh):
        spl = jax_project(means, cov6, jcam, opacity=opac)
        view = jcam.view_matrix()
        cam_pos = -jnp.einsum("ji,j->i", view[:3, :3], view[:3, 3])
        dirs = means - cam_pos
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1,
                                      keepdims=True).clip(1e-12)
        rgb = jax_color(color, sh, dirs, SH_DEG, False)
        table = jnp.concatenate(
            [spl.xy, spl.conic, rgb, (opac * spl.mask)[:, None]], axis=1)
        return jnp.sum(table * 1e-6)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(nn(p)) for p in params))
    for name, a, b in zip(("means", "cov6", "colour", "opacity", "sh"), got,
                          want):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0, name
        err = np.abs(nn(a) - b).max() / scale
        assert err <= NSCALE_TOL, (name, err)


def test_bench_nscale_pieces(setup):
    """The attribute-major SH colour's gradients and the closed form's
    (sh_bwd(plain)) are the port layout's (1e-5 normalized), sh_color's
    (on the CPU the same graph) bit for bit; table_bwd(all) is bench_bwd's
    nscale; proj_bwd gives finite gradients of means and cov6."""
    params, cam, _ = setup
    st = bench_nscale.stages(params, cam, SH_DEG)
    by_row = st["sh_bwd[N,15,3]"]()
    by_col = st["sh_bwd[45,N]"]()
    for a, b in zip(by_row, by_col):
        want = nn(a).reshape(N, -1)
        err = np.abs(nn(b).T - want).max() / np.abs(want).max()
        assert err <= NSCALE_TOL, err
    _same(st["sh_bwd(kernel)"](), by_row, "sh_bwd(kernel)")
    for a, b in zip(by_row, st["sh_bwd(plain)"]()):
        err = np.abs(nn(b) - nn(a)).max() / np.abs(nn(a)).max()
        assert err <= NSCALE_TOL, err
    assert st["sh_fwd(kernel)"]().shape == (N, 3)
    _same(st["table_bwd(all)"](), bench_bwd.nscale(params, cam, SH_DEG),
          "table_bwd")
    g_means, g_cov = st["proj_bwd"]()
    assert g_means.shape == (N, 3) and g_cov.shape == (N, 6)
    assert torch.isfinite(g_means).all() and torch.isfinite(g_cov).all()


def test_variant_stages_compute_the_pieces():
    """bench_bwd --variants' pieces on a small draw, against numpy."""
    f_pad, n = 4096, 1000
    st = bench_bwd.variant_stages(f_pad, n, device="cpu")
    keys, cols = st["sortonly"]()
    assert (np.diff(nn(keys)) >= 0).all() and len(cols) == 9
    stacked = nn(st["stack16+cs"]())
    assert stacked.shape == (f_pad, 16) and not stacked[:, 9:].any()
    np.testing.assert_array_equal(nn(st["stack9+cs"]()), stacked[:, :9])
    assert nn(st["gath9"]()).shape == (n, 9)
    assert nn(st["gath16"]()).shape == (n, 16)


def test_mains_raise_on_cpu_and_derived_slices():
    """Every tool's main raises on a CPU device, before any work; the
    derived slices are the JAX tool's differences."""
    for tool, extra in ((pc, []), (bench_bin, []), (bench_bwd, []),
                        (bench_bwd, ["--variants"]), (bench_nscale, [])):
        with pytest.raises(ValueError, match="CUDA card"):
            tool.main(["--device", "cpu", *extra])
    ms = dict(project=1.0, color=2.0, bin=3.0, sched=3.5, gather=4.5,
              fwd=5.0, step=14.0, kernel_fwd=0.5, kernel_fwd_bwd=2.0,
              reorder=0.75, nscale=6.0)
    readings = {k: {"device_ms": v, "by_kind": {"elementwise": v / 2}}
                for k, v in ms.items()}
    d = pc.derived(readings)
    assert d["kernel_bwd"]["device_ms"] == 1.5
    assert d["gather_slice"]["device_ms"] == 1.0
    assert d["kernel_fwd_slice"]["device_ms"] == 0.5
    assert d["glue_bwd"]["device_ms"] == 14.0 - 5.0 - 1.5
    assert d["glue_bwd"]["by_kind"] == {"elementwise": 3.75}
    assert d["nscale_bwd"]["device_ms"] == 4.0
    assert d["glue_bwd_rest"]["device_ms"] == 7.5 - 4.0 - 0.75
    # The partition sums to the step, in device ms and in shares.
    parts = [readings["project"], readings["reorder"]] + [
        d[k] for k in ("sh_colour", "binning", "sched_slice",
                       "gather_slice", "kernel_fwd_slice", "kernel_bwd",
                       "nscale_bwd", "glue_bwd_rest")]
    assert sum(p["device_ms"] for p in parts) == 14.0
    assert d["glue_bwd"]["share"] == 7.5 / 14.0
