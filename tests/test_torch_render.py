"""The port's forward render as a whole against the JAX package's jnp sweep
(`sweep_render(..., use_pallas=False)`) on the FBM cloud, and the plain
sweep's grid gradient against jax.grad of the same loss."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from test_torch_sweep_fwd import torch_plan
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu_torch.ops.sweep import sweep_render

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def cloud():
    return np.asarray(J.cloud_volume(32, 7))


def _configs(emission, eye=(3.0, 3.0, 3.0)):
    cam_kw = dict(eye=eye, width=96, height=64)
    return (J.RenderConfig(emission=emission, quadrature="sliced"),
            J.MediumConfig(combine="single", density=8.0),
            J.make_camera(J.CameraConfig(**cam_kw)),
            T.RenderConfig(emission=emission, quadrature="sliced"),
            T.MediumConfig(combine="single", density=8.0),
            T.make_camera(T.CameraConfig(**cam_kw)))


@pytest.mark.parametrize("emission,eye", [(True, (3.0, 3.0, 3.0)),
                                          (False, (-2.5, 0.8, -1.0))])
def test_render_image_matches_jax(cloud, emission, eye):
    jcfg, jmed, jcam, tcfg, tmed, tcam = _configs(emission, eye)
    jplan = jsweep.plan_sweep(jcam, cloud.shape, jcfg)
    want = np.asarray(jsweep.sweep_render(jnp.asarray(cloud), jplan, jcfg,
                                          jmed, use_pallas=False))
    grid = torch.from_numpy(cloud.copy())
    # On one plan: the sweep, warp and post-warp transform.
    got = sweep_render(grid, torch_plan(jplan), tcfg, tmed)
    assert got.shape == want.shape == (64, 96, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # End to end through the public entry point, with the port's own
    # camera and plan: the two plans' warp coords differ by ~3e-7
    # (float32 atan), which moves a pixel's taps by ~4e-5 base texels, so
    # the image is held to atol 1e-4.
    got = T.render_image(grid, tcam, tcfg, tmed)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4)
    assert float(got[..., 3].max()) > 0.0


def test_grid_gradient_matches_jax(cloud):
    """d/dgrid of sum(rgb^2) through the plain sweep and the warp, on the
    flagship's emission medium: the reference the backward kernel port
    will be held to."""
    jcfg, jmed, jcam, tcfg, tmed, _ = _configs(True)
    jplan = jsweep.plan_sweep(jcam, cloud.shape, jcfg)

    def loss(g):
        img = jsweep.sweep_render(g, jplan, jcfg, jmed, use_pallas=False)
        return jnp.sum(img[..., :3] ** 2)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.grad(loss)(jnp.asarray(cloud)))
    grid = torch.from_numpy(cloud.copy()).requires_grad_()
    img = sweep_render(grid, torch_plan(jplan), tcfg, tmed)
    (img[..., :3] ** 2).sum().backward()
    got = grid.grad.numpy()
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def test_render_backends_and_errors(cloud):
    _, _, _, tcfg, tmed, tcam = _configs(True)
    grid = torch.from_numpy(cloud.copy())
    auto = T.render_image(grid, tcam, tcfg, tmed)
    plan = T.plan_for(tcam, grid.shape, tcfg)
    torch.testing.assert_close(
        T.render(grid, tcam, tcfg, tmed, backend="pallas", plan=plan), auto)
    with pytest.raises(ValueError, match="unknown backend"):
        T.render_image(grid, tcam, tcfg, tmed, backend="swep")
    with pytest.raises(NotImplementedError):
        T.render_image(grid, tcam, tcfg, tmed, backend="reference")
    with pytest.raises(NotImplementedError):
        T.render_image(grid, tcam, dataclasses.replace(tcfg,
                                                       quadrature="fixed"),
                       tmed)
    with pytest.raises(ValueError, match="sliced"):
        T.render_image(grid, tcam, dataclasses.replace(tcfg,
                                                       quadrature="fixed"),
                       tmed, backend="sweep")
    with pytest.raises(NotImplementedError):
        T.render_image(grid, tcam, tcfg, T.MediumConfig(), plan=plan)
    with pytest.raises(NotImplementedError):
        T.render_image(grid[..., None], tcam, tcfg, tmed, plan=plan)
    with pytest.raises(NotImplementedError, match="shadow"):
        T.render_image(grid, tcam, tcfg, tmed,
                       light=T.LightConfig(shadow_steps=32))
