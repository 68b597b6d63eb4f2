"""The training path: the port's config-3 target (bake_scene of
config3_scene), its fit_grid with torch.optim.Adam, checkpoints that cross
between the two packages, the NaN guard and `cli fit`, against the JAX
package on the same inputs at 16^3 / 48x48.

Tolerances:
* the baked target is trilinear sampling in float32: rtol=1e-6, atol=1e-6;
* the first step's gradient: rtol=2e-4, atol=2e-4 * max|grad|, as the
  sweep's gradient is held to JAX's (tests/test_sweep_pallas.py);
* multi-step fits: Adam turns any gradient into a step of about lr, so a
  near-zero gradient whose sign rounds differently moves a voxel by
  +-lr in one package and -+lr in the other. The fits are compared by
  their loss curves (rtol=1e-4) and, on the voxels whose first-step
  |grad| exceeds 1e-2 of the maximum, by the grid (atol=1e-4).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from volumetricrenderer_tpu import fit as jfit
from volumetricrenderer_tpu.models import scene as jscene
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu.utils import checkpoint as jckpt
from volumetricrenderer_tpu_torch import cli
from volumetricrenderer_tpu_torch import fit as tfit
from volumetricrenderer_tpu_torch.kernels import sweep_bwd, sweep_fwd
from volumetricrenderer_tpu_torch.models import scene as tscene
from volumetricrenderer_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

SIZE, IMG, LR = 16, 48, 5e-2
GRAD_FRACTION = 1e-2


@pytest.fixture(scope="module")
def problem():
    """Config 3 at 16^3 / 48x48: the baked cloud+smoke target, its image
    (rendered by the JAX package), and the first step's JAX gradient."""
    jcfg = J.RenderConfig(emission=True, quadrature="sliced")
    jmed = J.MediumConfig(combine="single", density=8.0)
    jcam = J.make_camera(J.CameraConfig(width=IMG, height=IMG))
    true_grid = jscene.bake_scene(jscene.config3_scene(SIZE), SIZE, jcfg)
    target = np.array(J.render_image(true_grid, jcam, jcfg, jmed,
                                     J.LightConfig())[..., :3])
    plan = jsweep.plan_sweep(jcam, (SIZE,) * 3, jcfg)

    def loss(g):
        img = jsweep.sweep_render(g, plan, jcfg, jmed, J.LightConfig())
        return jnp.mean((img[..., :3] - target) ** 2)
    grad0 = np.asarray(jax.grad(loss)(jnp.full((SIZE,) * 3, 0.1,
                                               jnp.float32)))
    return dict(true_grid=np.asarray(true_grid), target=target, grad0=grad0,
                jargs=(jcam, jcfg, jmed, J.LightConfig()),
                targs=(T.make_camera(T.CameraConfig(width=IMG, height=IMG)),
                       T.RenderConfig(emission=True, quadrature="sliced"),
                       T.MediumConfig(combine="single", density=8.0),
                       T.LightConfig()))


def _jax_fit(p, steps, **kw):
    return jfit.fit_grid(jnp.asarray(p["target"]), *p["jargs"],
                         grid_size=SIZE, steps=steps, learning_rate=LR, **kw)


def _torch_fit(p, steps, **kw):
    return tfit.fit_grid(torch.from_numpy(p["target"]), *p["targs"],
                         grid_size=SIZE, steps=steps, learning_rate=LR, **kw)


def _assert_fits_close(p, t_losses, t_grid, j_losses, j_grid):
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    strong = np.abs(p["grad0"]) > GRAD_FRACTION * np.abs(p["grad0"]).max()
    assert strong.sum() > 100
    np.testing.assert_allclose(np.asarray(t_grid)[strong],
                               np.asarray(j_grid)[strong], atol=1e-4)


def test_bake_config3_scene_matches_jax(problem):
    cfg = T.RenderConfig(emission=True, quadrature="sliced")
    got = tscene.bake_scene(tscene.config3_scene(SIZE), SIZE, cfg)
    assert tuple(got.shape) == (SIZE,) * 3
    np.testing.assert_allclose(got.numpy(), problem["true_grid"], rtol=1e-6,
                               atol=1e-6)
    assert float(got.max()) > 0.5  # both volumes landed in the box
    for tv, jv in zip(tscene.config3_scene(SIZE),
                      jscene.config3_scene(SIZE)):
        np.testing.assert_array_equal(tv.world_to_local.numpy(),
                                      np.asarray(jv.world_to_local))


def test_first_step_gradient_matches_jax(problem):
    cam, cfg, med, light = problem["targs"]
    grid = torch.full((SIZE,) * 3, 0.1, requires_grad=True)
    img = T.render_image(grid, cam, cfg, med, light)
    loss = torch.mean((img[..., :3] - torch.from_numpy(problem["target"]))
                      ** 2)
    loss.backward()
    want = problem["grad0"]
    np.testing.assert_allclose(grid.grad.numpy(), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def test_fit_matches_jax(problem):
    got = _torch_fit(problem, 5)
    want = _jax_fit(problem, 5)
    assert got.skipped_steps == want.skipped_steps == 0
    assert got.losses[-1] < got.losses[0]
    assert got.grid.shape == (SIZE,) * 3 and got.grid.dtype == torch.float32
    assert 0.0 <= float(got.grid.min()) and float(got.grid.max()) <= 1.0
    _assert_fits_close(problem, got.losses, got.grid.numpy(), want.losses,
                       want.grid)


def test_fit_fixed_quadrature_matches_jax(problem):
    kw = dict(max_steps=32, step_size=4.0 / 32.0, emission=True)
    jcam, _, jmed, jl = problem["jargs"]
    tcam, _, tmed, tl = problem["targs"]
    target = problem["target"][::4, ::4]  # 12x12 rays
    jcam = J.make_camera(J.CameraConfig(width=12, height=12))
    tcam = T.make_camera(T.CameraConfig(width=12, height=12))
    want = jfit.fit_grid(jnp.asarray(target), jcam, J.RenderConfig(**kw),
                         jmed, jl, grid_size=8, steps=3, learning_rate=LR)
    got = tfit.fit_grid(torch.from_numpy(target.copy()), tcam,
                        T.RenderConfig(**kw), tmed, tl, grid_size=8,
                        steps=3, learning_rate=LR)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_across_packages(problem, writer, tmp_path):
    """A fit checkpointed at step 2 by one package and resumed to step 4
    by the other continues the uninterrupted JAX fit: same grid, same
    Adam state (count, mu, nu)."""
    whole = _jax_fit(problem, 4)
    ckpt = str(tmp_path / "ckpt")
    if writer == "jax":
        _jax_fit(problem, 2, checkpoint_every=2,
                 checkpoint_fn=lambda s, g, st: jckpt.save_checkpoint(
                     ckpt, s, g, st))
        step, grid, opt, _ = tckpt.restore_checkpoint(
            ckpt, opt_state_template=tckpt.adam_initial_leaves((SIZE,) * 3))
        assert int(opt[0]) == 2
        res = _torch_fit(problem, 4, init_grid=torch.from_numpy(grid),
                         init_opt_state=opt, start_step=step)
        tail, grid_end = res.losses, res.grid.numpy()
    else:
        _torch_fit(problem, 2, checkpoint_every=2,
                   checkpoint_fn=lambda s, g, st: tckpt.save_checkpoint(
                       ckpt, s, g, st))
        step, grid, opt, _ = jckpt.restore_checkpoint(
            ckpt, opt_state_template=optax.adam(LR).init(
                jnp.zeros((SIZE,) * 3, jnp.float32)))
        assert int(opt[0].count) == 2
        res = _jax_fit(problem, 4, init_grid=grid, init_opt_state=opt,
                       start_step=step)
        tail, grid_end = res.losses, np.asarray(res.grid)
    assert step == 2 and len(tail) == 2
    _assert_fits_close(problem, tail, grid_end, whole.losses[2:],
                       whole.grid)


def test_adam_leaves_round_trip():
    p = torch.nn.Parameter(torch.rand(3, 4, 5))
    opt = torch.optim.Adam([p], lr=LR)
    assert int(tckpt.adam_state_to_leaves(opt, p)[0]) == 0
    p.grad = torch.rand(3, 4, 5)
    opt.step()
    leaves = tckpt.adam_state_to_leaves(opt, p)
    assert leaves[0].dtype == np.int32 and int(leaves[0]) == 1
    st = tckpt.adam_state_from_leaves(leaves, p)
    for key in ("exp_avg", "exp_avg_sq"):
        torch.testing.assert_close(st[key], opt.state[p][key], rtol=0,
                                   atol=0)
    assert float(st["step"]) == 1.0


def test_nan_guard_skips_steps(problem):
    """Non-finite loss: no step is applied, the grid and the Adam state
    stay as they were, in both packages."""
    target = problem["target"].copy()
    target[3, 5, 1] = np.nan
    saved = []
    got = tfit.fit_grid(torch.from_numpy(target), *problem["targs"],
                        grid_size=SIZE, steps=3, learning_rate=LR,
                        checkpoint_every=3,
                        checkpoint_fn=lambda s, g, st: saved.append(st))
    want = jfit.fit_grid(jnp.asarray(target), *problem["jargs"],
                         grid_size=SIZE, steps=3, learning_rate=LR)
    assert got.skipped_steps == want.skipped_steps == 3
    assert np.isnan(got.losses).all()
    np.testing.assert_array_equal(got.grid.numpy(), np.asarray(want.grid))
    np.testing.assert_array_equal(got.grid.numpy(), np.full((SIZE,) * 3,
                                                            0.1, np.float32))
    count, mu, nu = saved[0]
    assert int(count) == 0 and not mu.any() and not nu.any()


def test_cpu_fit_launches_no_kernel(problem):
    before = (sweep_fwd.launches, sweep_bwd.launches)
    _torch_fit(problem, 1)
    assert (sweep_fwd.launches, sweep_bwd.launches) == before


def test_cli_fit_writes_artifacts_and_resumes(tmp_path):
    out = str(tmp_path / "run")
    args = ["fit", "--size", "8", "--image-size", "16", "--steps", "4",
            "--out-dir", out]
    assert cli.main(args) == 0
    for name in ("target.png", "fitted.png", "metrics.jsonl"):
        assert os.path.getsize(os.path.join(out, name)) > 0
    assert tckpt.latest_step(os.path.join(out, "ckpt")) == 4
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 2  # steps 0 and 3
    # Resuming a finished fit does nothing more; another quadrature is
    # refused.
    assert cli.main(args + ["--resume"]) == 0
    with pytest.raises(SystemExit, match="quadrature"):
        cli.main(args + ["--resume", "--quadrature", "fixed"])


def test_cli_fit_fixed_quadrature(tmp_path):
    out = str(tmp_path / "run")
    assert cli.main(["fit", "--size", "6", "--image-size", "8", "--steps",
                     "2", "--out-dir", out, "--quadrature", "fixed"]) == 0
    assert os.path.exists(os.path.join(out, "fitted.png"))
    _, _, _, extra = tckpt.restore_checkpoint(os.path.join(out, "ckpt"))
    assert extra == {"quadrature": "fixed"}
