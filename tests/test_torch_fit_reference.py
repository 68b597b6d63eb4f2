"""The four-channel fit: fit_grid and `cli fit --preset reference` on the
reference medium (the upstream's 128^3 x 4 noise scene, here 16^3 x 4,
in absorption), against the JAX package's fit_grid given the same
4-channel init grid and against the benchmark's plain reference
(benchmark/reference_ref_fit.py); the channel layers' autograd node
(kernels/sweep_ref_fwd.py _LayerChannels) and absorption's display
transform (ops/sweep.py _BeerLambert) against autograd of the forms they
replaced; the layers' span and counter in a fit step.

Tolerances, tests/test_torch_fit.py's and for its reasons:
* the first step's gradient: rtol=2e-4, atol=2e-4 * max|grad|, as the
  sweep's gradient is held to JAX's;
* multi-step fits: Adam turns any gradient into a step of about lr, so a
  near-zero gradient whose sign rounds differently moves a voxel by
  +-lr in one package and -+lr in the other. The fits are compared by
  their loss curves (rtol=1e-4) and, on the voxels whose first-step
  |grad| exceeds 1e-2 of the maximum, by the grid (atol=1e-4).
The two nodes' forwards are the old forms' bit for bit; their gradients
sum the same products in another order (one index_add_ in place of
eight, the adjoint written out), so they are held at rtol=1e-6,
atol=1e-6 * max|grad|: a few float32 roundings of a sum.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from benchmark import plan as bplan
from benchmark import reference_ref_fit
from volumetricrenderer_tpu import fit as jfit
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu_torch import cli
from volumetricrenderer_tpu_torch import fit as tfit
from volumetricrenderer_tpu_torch.kernels import sweep_ref_fwd
from volumetricrenderer_tpu_torch.ops.sampling import apply_address_mode
from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep
from volumetricrenderer_tpu_torch.utils import checkpoint as tckpt
from volumetricrenderer_tpu_torch.utils import clock

torch.set_num_threads(1)

SIZE, W, H, LR, STEPS = 16, 32, 24, 5e-2, 3
GRAD_FRACTION = 1e-2
SHAPE = (SIZE,) * 3 + (4,)


def _old_layer_channels(gperm4, slice_z, medium, offs, address_mode):
    """_layer_channels as it was before its autograd node: eight
    index_select, two stacks and the lerp, differentiated by autograd."""
    depth = gperm4.shape[0]
    dev = slice_z.device
    scales = torch.tensor(medium.channel_coord_scale, dtype=torch.float32,
                          device=dev)
    offk = torch.stack([offs[c][0] for c in range(4)]).to(dev)
    p = (scales[:, None] * slice_z + offk[:, None]) * depth - 0.5
    i0f = torch.floor(p)
    f = (p - i0f).to(torch.float32).T[:, :, None, None]
    i0 = i0f.to(torch.int64)
    l0 = apply_address_mode(i0, depth, address_mode)
    l1 = apply_address_mode(i0 + 1, depth, address_mode)
    g = gperm4.to(torch.float32)
    lo, hi = (torch.stack([torch.index_select(g[..., c], 0, layer[c])
                           for c in range(4)], dim=1) for layer in (l0, l1))
    return lo * (1.0 - f) + hi * f


@pytest.fixture(scope="module")
def problem():
    """The reference preset's medium at 16^3 x 4 seen at 32x24 from its
    camera: the true grid (the port's build_volume), its target (rendered
    by the JAX package) and the first step's JAX gradient at the 0.1
    grid."""
    true_grid = T.build_volume(T.VolumeConfig(size=SIZE), device="cpu")
    jcfg = J.RenderConfig(quadrature="sliced")
    jmed = J.MediumConfig()
    jcam = J.make_camera(J.CameraConfig(width=W, height=H))
    target = np.array(J.render_image(jnp.asarray(true_grid.numpy()), jcam,
                                     jcfg, jmed, J.LightConfig())[..., :3])
    plan = jsweep.plan_sweep(jcam, SHAPE, jcfg)

    def loss(g):
        img = jsweep.sweep_render(g, plan, jcfg, jmed, J.LightConfig())
        return jnp.mean((img[..., :3] - target) ** 2)
    grad0 = np.asarray(jax.grad(loss)(jnp.full(SHAPE, 0.1, jnp.float32)))
    return dict(true_grid=true_grid, target=target, grad0=grad0,
                jargs=(jcam, jcfg, jmed, J.LightConfig()),
                targs=(T.make_camera(T.CameraConfig(width=W, height=H)),
                       T.RenderConfig(quadrature="sliced"),
                       T.MediumConfig(), T.LightConfig()))


def _torch_fit(p, steps, **kw):
    return tfit.fit_grid(torch.from_numpy(p["target"]), *p["targs"],
                         grid_size=SIZE, steps=steps, learning_rate=LR,
                         **kw)


def _assert_fits_close(p, t_losses, t_grid, w_losses, w_grid):
    np.testing.assert_allclose(t_losses, w_losses, rtol=1e-4)
    strong = np.abs(p["grad0"]) > GRAD_FRACTION * np.abs(p["grad0"]).max()
    assert strong.sum() > 100
    for c in range(4):  # every channel is fitted
        assert strong[..., c].sum() > 10, c
    np.testing.assert_allclose(np.asarray(t_grid)[strong],
                               np.asarray(w_grid)[strong], atol=1e-4)


def test_fit_grid_starts_four_channels_at_0_1(problem):
    res = _torch_fit(problem, 0)
    assert res.grid.shape == SHAPE and res.grid.dtype == torch.float32
    assert bool((res.grid == 0.1).all()) and res.losses == []
    single = tfit.fit_grid(torch.from_numpy(problem["target"]),
                           problem["targs"][0], problem["targs"][1],
                           T.MediumConfig(combine="single"), grid_size=SIZE,
                           steps=0, device="cpu")
    assert single.grid.shape == (SIZE,) * 3


def test_first_step_gradient_matches_jax(problem):
    cam, cfg, med, light = problem["targs"]
    grid = torch.full(SHAPE, 0.1, requires_grad=True)
    img = T.render_image(grid, cam, cfg, med, light)
    loss = torch.mean((img[..., :3] - torch.from_numpy(problem["target"]))
                      ** 2)
    loss.backward()
    want = problem["grad0"]
    assert float(np.abs(want).reshape(-1, 4).max(0).min()) > 0.0
    np.testing.assert_allclose(grid.grad.numpy(), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def test_fit_matches_jax(problem):
    init = np.full(SHAPE, 0.1, np.float32)
    got = _torch_fit(problem, STEPS, init_grid=torch.from_numpy(init))
    want = jfit.fit_grid(jnp.asarray(problem["target"]), *problem["jargs"],
                         grid_size=SIZE, steps=STEPS, learning_rate=LR,
                         init_grid=jnp.asarray(init))
    assert got.skipped_steps == want.skipped_steps == 0
    assert got.losses[-1] < got.losses[0]
    assert got.grid.shape == SHAPE
    assert 0.0 <= float(got.grid.min()) and float(got.grid.max()) <= 1.0
    _assert_fits_close(problem, got.losses, got.grid.numpy(), want.losses,
                       want.grid)


def test_fit_matches_the_benchmark_reference(problem):
    """fit_grid from its own 4-channel init against
    benchmark/reference_ref_fit.py on the benchmark's plan of the same
    camera: losses, the first gradient (the program's from its Adam first
    moment after step 1) and the grid after the last step."""
    saved = []  # on the CPU the leaves are views of the live Adam state
    got = _torch_fit(problem, STEPS, checkpoint_every=1,
                     checkpoint_fn=lambda s, g, st: saved.append(
                         (g.clone(), [np.array(x) for x in st])))
    cam = {"eye": [3.0, 3.0, 3.0], "center": [0.0, 0.0, 0.0],
           "up": [0.0, 0.0, 1.0], "fov_y_degrees": 45.0, "width": W,
           "height": H}
    plan = bplan.make_plan(cam, SHAPE[:3], "cpu")
    med = {**{k: getattr(T.MediumConfig(), k) for k in (
        "channel_coord_scale", "channel_scroll_weight", "sample_scale",
        "density")}, "background": [0.0, 0.0, 0.0]}
    losses, g1, change, grid = reference_ref_fit.fit_steps(
        torch.from_numpy(problem["target"]), plan, med, SIZE, LR, STEPS)
    assert len(saved) == STEPS
    np.testing.assert_allclose(got.losses, losses, rtol=1e-4)
    want = g1.numpy()
    np.testing.assert_allclose(np.asarray(saved[0][1][1]) / 0.1, want,
                               rtol=2e-4, atol=2e-4 * np.abs(want).max())
    _assert_fits_close(problem, got.losses, got.grid.numpy(), losses,
                       grid.numpy())
    np.testing.assert_allclose((got.grid - 0.1).numpy(), change.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("eye", [(3.0, 3.0, 3.0), (-3.5, 1.0, 2.0),
                                 (0.5, -3.0, -3.2)])
def test_layers_node_matches_the_old_form(eye):
    """The node's forward equals the old _layer_channels bit for bit, and
    its gradient autograd's through the old form, on a seeded scroll that
    pushes every channel's layers past the box's faces (mirror
    addressing), on a (D, A, B, 5) grid whose fifth channel gets none."""
    cfg = T.RenderConfig(quadrature="sliced")
    med = T.MediumConfig()
    cam = T.make_camera(T.CameraConfig(eye=eye, width=W, height=H))
    plan = plan_sweep(cam, SHAPE, cfg, supersample=cfg.sweep_supersample)
    rng = np.random.default_rng(11)
    grid = torch.tensor(rng.uniform(0.0, 1.0, (12, 10, 14, 5)),
                        dtype=torch.float32)
    scroll = torch.tensor(rng.uniform(-2.0, 2.0, (4, 3)),
                          dtype=torch.float32)
    offs = sweep_ref_fwd._channel_offsets(med, scroll, plan.coord_order)
    gperm = grid.permute(plan.perm + (3,))
    # The taps cross the box's faces: the address mode mirrors them.
    depth = gperm.shape[0]
    offk = torch.stack([offs[c][0] for c in range(4)])
    i0 = torch.floor((torch.tensor(med.channel_coord_scale)[:, None]
                      * plan.slice_z + offk[:, None]) * depth - 0.5)
    assert bool(((i0 < 0) | (i0 + 1 > depth - 1)).any())
    g_old = gperm.detach().clone().requires_grad_()
    g_new = gperm.detach().clone().requires_grad_()
    old = _old_layer_channels(g_old, plan.slice_z, med, offs, "mirror")
    before = sweep_ref_fwd.layer_backwards
    new = sweep_ref_fwd._layer_channels(g_new, plan.slice_z, med, offs,
                                        "mirror")
    assert new.grad_fn.name() == "_LayerChannelsBackward"
    assert torch.equal(new, old)
    with torch.no_grad():
        assert torch.equal(sweep_ref_fwd._layer_channels(
            gperm, plan.slice_z, med, offs, "mirror"), old)
    ct = torch.tensor(rng.normal(size=tuple(old.shape)),
                      dtype=torch.float32)
    (want,) = torch.autograd.grad(old, g_old, ct)
    (got,) = torch.autograd.grad(new, g_new, ct)
    assert sweep_ref_fwd.layer_backwards == before + 1
    assert got.shape == gperm.shape and got.dtype == torch.float32
    assert bool((got[..., 4] == 0).all())
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * scale)



def _old_beer_lambert(out, density, background):
    """postwarp_pixels' absorption branch as autograd took it before its
    node."""
    gray = 1.0 - torch.exp(-density * out[..., 0])
    hitp = torch.clamp(out[..., 1], 0.0, 1.0)
    rgb = (gray[..., None] * hitp[..., None]
           + background * (1.0 - hitp[..., None]))
    return torch.cat([rgb, hitp[..., None]], dim=-1)


def test_beer_lambert_node_matches_autograd():
    """Absorption's display transform under autograd (ops/sweep.py
    _BeerLambert): its pixels bit for bit those of the plain branch and of
    the autograd form it replaced, its gradient that form's (a few float32
    roundings apart), with hit values below 0, at 0 and 1 and above 1 (the
    clamp's gradient passes on [0, 1] alone) and a background of three
    values."""
    from volumetricrenderer_tpu_torch.ops.sweep import postwarp_pixels
    rng = np.random.default_rng(5)
    out = torch.tensor(rng.uniform(-0.3, 1.4, (9, 11, 2)),
                       dtype=torch.float32)
    out[0, :4, 1] = torch.tensor([0.0, 1.0, -0.0, 1.0 + 1e-6])
    cfg = T.RenderConfig(background=(0.1, 0.25, 0.4))
    med = T.MediumConfig(density=1.7)
    background = torch.tensor(cfg.background)
    a, b = (out.clone().requires_grad_() for _ in range(2))
    want = _old_beer_lambert(a, med.density, background)
    got = postwarp_pixels(b, cfg, med)
    assert got.grad_fn.name() == "_BeerLambertBackward"
    assert torch.equal(got, want)
    assert torch.equal(postwarp_pixels(out, cfg, med), want.detach())
    ct = torch.tensor(rng.normal(size=(9, 11, 4)), dtype=torch.float32)
    (g_want,) = torch.autograd.grad(want, a, ct)
    (g_got,) = torch.autograd.grad(got, b, ct)
    inside = (out[..., 1] >= 0.0) & (out[..., 1] <= 1.0)
    assert bool((g_got[..., 1][~inside] == 0).all()) and bool((~inside).any())
    scale = float(g_want.abs().max())
    torch.testing.assert_close(g_got, g_want, rtol=1e-6, atol=1e-6 * scale)

def test_cli_fit_preset_reference_writes_and_resumes(tmp_path):
    """`fit --preset reference` at 8^3 x 4 and a 16x16 target: it runs
    through the 4-channel sweep, writes its images, checkpoints the
    (8, 8, 8, 4) grid and its Adam state, and resumes to more steps."""
    out = str(tmp_path / "run")
    args = ["fit", "--preset", "reference", "--size", "8", "--image-size",
            "16", "--out-dir", out, "--device", "cpu"]
    assert cli.main(args + ["--steps", "2"]) == 0
    for name in ("target.png", "fitted.png", "metrics.jsonl"):
        assert os.path.getsize(os.path.join(out, name)) > 0
    ckpt = os.path.join(out, "ckpt")
    step, grid, opt, extra = tckpt.restore_checkpoint(ckpt)
    assert step == 2 and grid.shape == (8, 8, 8, 4)
    assert extra == {"quadrature": "sliced"}
    before = sweep_ref_fwd.layer_backwards
    assert cli.main(args + ["--steps", "4", "--resume"]) == 0
    assert sweep_ref_fwd.layer_backwards == before + 2
    step, grid, opt, _ = tckpt.restore_checkpoint(
        ckpt, opt_state_template=tckpt.adam_initial_leaves((8, 8, 8, 4)))
    assert step == 4 and int(opt[0]) == 4 and opt[1].shape == (8, 8, 8, 4)


def test_fit_step_records_the_layers_backward_span(problem):
    """Each step of a 4-channel fit records "sweep.ref_layers_bwd" once,
    under its request id, inside "fit.backward" (on the CPU autograd runs
    on the calling thread), with a device interval (the host interval off
    CUDA); the counter moves once a step."""
    clock.clear_spans()
    before = sweep_ref_fwd.layer_backwards
    try:
        with clock.tracing():
            _torch_fit(problem, 2)
        spans = clock.spans()
    finally:
        clock.clear_spans()
    assert sweep_ref_fwd.layer_backwards == before + 2
    steps = [s for s in spans if s.name == "fit.step"]
    assert [s.request for s in steps] == [0, 1]
    for step in steps:
        mine = {s.name: s for s in spans if s.request == step.request}
        bwd, layers = mine["sweep.ref_layers_bwd"], mine["sweep.ref_layers"]
        assert [s.name for s in spans if s.request == step.request].count(
            "sweep.ref_layers_bwd") == 1
        assert bwd.parent == mine["fit.backward"].id
        assert layers.t1_ns <= bwd.t0_ns
        assert bwd.device_ns == bwd.t1_ns - bwd.t0_ns > 0
