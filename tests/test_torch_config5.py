"""BASELINE config 5's fit, scaled down for the CPU: the benchmark's
config5 recipe (benchmark/configs/config5.json: the FBM cloud, emission,
sliced quadrature at voxel-plane slices, supersample 1.5, density 8,
Adam at lr 0.05 from the 0.1 grid, the clamp) at a 16^3 cloud and a
32x18 (16:9) target, seeded. The port's fit_grid (its kernels' plain
versions) runs three steps and is held to the benchmark's plain reference
(benchmark/reference.py fit_steps) and to the JAX package's fit_grid on
the same target.

Tolerances, each one that the reference computed in TF32 (the control,
one precision below float32) fails, which the tests assert beside it:
* losses against the reference: rel 1e-6. Both sum the same float32
  image; the port reads 0.8e-7-1.9e-7, TF32 4.8e-4-5.4e-4.
* the first gradient (the port's from Adam's first moment after step 1,
  / (1 - beta1), as benchmark/drivers/fit.py reads it): atol 1e-6 of the
  largest |gradient|, rtol 1e-5. The port's sums run in another order:
  1.4e-7 of the largest; TF32 6e-4-9e-4.
* the grid's change after three steps: atol 1e-6, rtol 1e-5, as the
  benchmark's own test of fit_steps. The port 2.2e-8-3.0e-8; TF32
  7e-5-4.9e-3, where a near-zero gradient's sign rounds otherwise and
  Adam moves the voxel the other way.
* losses against JAX: rel 1e-4, as tests/test_torch_fit.py. JAX's sweep
  reads 3.6e-5-4.2e-5 off the port and the reference alike; TF32 4.8e-4.
* the grid against JAX on the voxels whose first |gradient| exceeds 1e-2
  of the largest (elsewhere a near-zero gradient's sign decides, as
  tests/test_torch_fit.py says): atol 1e-5. The port 5e-7-9e-7; TF32
  5e-5-1.4e-4.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from volumetricrenderer_tpu import fit as jfit
from volumetricrenderer_tpu_torch.fit import fit_grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import plan as bplan  # noqa: E402
from benchmark import reference, scene  # noqa: E402

torch.set_num_threads(1)

SIZE, W, H, STEPS, SEED = 16, 32, 18, 3, 2**31 + 77
GRAD_FRACTION = 1e-2


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs", "config5.json")) \
            as f:
        return json.load(f)


@pytest.fixture(scope="module")
def problem():
    c = _config()
    cam = {k: c["camera"][k] for k in ("eye", "center", "up",
                                       "fov_y_degrees")}
    cam.update(width=W, height=H)
    med = {**c["medium"],
           "early_stop_transmittance":
               c["render"]["early_stop_transmittance"],
           "background": c["render"]["background"],
           "ambient": c["light"]["ambient"],
           "light_color": c["light"]["color"],
           "light_direction": c["light"]["direction"]}
    lr = c["fit"]["learning_rate"]
    grid = scene.make_grid({**c["volume"], "size": SIZE}, SEED, "cpu")
    plan = bplan.make_plan(cam, grid.shape, "cpu",
                           c["render"]["sweep_supersample"])
    with torch.no_grad():
        target = reference.render(grid, plan, med)[..., :3].contiguous()

    p = T.PRESETS["config5"]
    tcam = T.make_camera(T.CameraConfig(width=W, height=H))
    kept = []
    res = fit_grid(target, tcam, p.render, p.medium, p.light,
                   grid_size=SIZE, steps=STEPS, learning_rate=lr,
                   checkpoint_every=1,
                   checkpoint_fn=lambda s, g, leaves: kept.append(
                       np.array(leaves[1])))
    port = (res.losses, torch.from_numpy(kept[0]) / (1.0 - 0.9),
            res.grid - c["fit"]["init"])
    ref = reference.fit_steps(target, plan, med, SIZE, lr, STEPS)
    tf32 = reference.fit_steps(target, plan, med, SIZE, lr, STEPS,
                               tf32=True)

    jp = J.PRESETS["config5"]
    jcam = J.make_camera(J.CameraConfig(width=W, height=H))
    jres = jfit.fit_grid(jnp.asarray(target.numpy()), jcam, jp.render,
                         jp.medium, jp.light, grid_size=SIZE, steps=STEPS,
                         learning_rate=lr)
    return dict(port=port, ref=ref, tf32=tf32, skipped=res.skipped_steps,
                jax=(jres.losses, np.asarray(jres.grid)),
                init=c["fit"]["init"])


def _losses_close(a, b, rel):
    return all(abs(x - y) <= rel * abs(y) for x, y in zip(a, b))


def test_config5_recipe_is_the_preset():
    """The benchmark's config5 and the port's PRESETS["config5"] are the
    same render, medium and camera; only the sizes are cut here."""
    c, p = _config(), T.PRESETS["config5"]
    assert c["volume"] == {"kind": "cloud", "size": p.volume.size} \
        and p.volume.size == 512
    assert (c["camera"]["width"], c["camera"]["height"]) == \
        (p.camera.width, p.camera.height) == (1920, 1080)
    assert tuple(c["camera"]["eye"]) == p.camera.eye
    assert c["camera"]["fov_y_degrees"] == p.camera.fov_y_degrees
    for key, value in c["render"].items():
        want = getattr(p.render, key)
        assert (tuple(value) if isinstance(value, list) else value) == want
    assert c["medium"] == {"combine": p.medium.combine,
                           "density": p.medium.density,
                           "sample_scale": p.medium.sample_scale}
    assert c["light"]["shadow_steps"] == p.light.shadow_steps == 0


def test_losses_match_the_reference(problem):
    assert problem["skipped"] == 0
    losses = problem["port"][0]
    assert len(losses) == STEPS and losses[-1] < losses[0]
    assert _losses_close(losses, problem["ref"][0], 1e-6)
    assert not _losses_close(problem["tf32"][0], problem["ref"][0], 1e-6)


def test_first_gradient_matches_the_reference(problem):
    want = problem["ref"][1]
    atol = 1e-6 * float(want.abs().max())
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(problem["port"][1], want, rtol=1e-5,
                               atol=atol)
    assert not torch.allclose(problem["tf32"][1], want, rtol=1e-5,
                              atol=atol)


def test_grid_change_matches_the_reference(problem):
    want = problem["ref"][2]
    assert float(want.abs().max()) > 1e-2  # Adam moved the grid
    torch.testing.assert_close(problem["port"][2], want, rtol=1e-5,
                               atol=1e-6)
    assert not torch.allclose(problem["tf32"][2], want, rtol=1e-5,
                              atol=1e-6)


def test_fit_matches_jax(problem):
    j_losses, j_grid = problem["jax"]
    assert _losses_close(problem["port"][0], j_losses, 1e-4)
    assert not _losses_close(problem["tf32"][0], j_losses, 1e-4)
    g0 = problem["ref"][1].numpy()
    strong = np.abs(g0) > GRAD_FRACTION * np.abs(g0).max()
    assert strong.sum() > 1000
    grid = problem["port"][2].numpy() + problem["init"]
    np.testing.assert_allclose(grid[strong], j_grid[strong], rtol=0,
                               atol=1e-5)
    tf32 = problem["tf32"][2].numpy() + problem["init"]
    assert np.abs(tf32[strong] - j_grid[strong]).max() > 1e-5
    assert 0.0 <= j_grid.min() and j_grid.max() <= 1.0
