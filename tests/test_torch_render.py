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
    with pytest.raises(NotImplementedError, match="fixed"):
        T.render_image(grid, tcam, dataclasses.replace(tcfg,
                                                       quadrature="fixed"),
                       tmed, backend="reference")
    with pytest.raises(NotImplementedError):
        T.render_image(grid, tcam, dataclasses.replace(tcfg,
                                                       quadrature="fixed"),
                       tmed)
    with pytest.raises(ValueError, match="sliced"):
        T.render_image(grid, tcam, dataclasses.replace(tcfg,
                                                       quadrature="fixed"),
                       tmed, backend="sweep")
    # the reference combine needs a 4-D grid, the single combine a 3-D one
    with pytest.raises(NotImplementedError):
        T.render_image(grid, tcam, tcfg, T.MediumConfig(), plan=plan)
    with pytest.raises(NotImplementedError):
        T.render_image(grid[..., None], tcam, tcfg, tmed, plan=plan)
    grid4 = grid[..., None].expand(-1, -1, -1, 4)
    with pytest.raises(NotImplementedError, match="light-volume slice"):
        T.render_image(grid4, tcam, tcfg, T.MediumConfig(), plan=plan,
                       light_volume=grid)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        T.render_image(grid4, tcam,
                       dataclasses.replace(tcfg, dtype="bfloat16"),
                       T.MediumConfig(), plan=plan)
    with pytest.raises(NotImplementedError, match="shadow"):
        T.render_image(grid, tcam, tcfg, tmed,
                       light=T.LightConfig(shadow_steps=32))


def _grid4(seed=0, d=16):
    return np.random.default_rng(seed).uniform(0.1, 1.0, (d, d, d, 4)) \
        .astype(np.float32)


def _scroll4(kind):
    if kind == "preset":
        return np.array(J.reference_media_scroll(1.7))
    return np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("emission,eye,kind", [
    (False, (3.0, 3.0, 3.0), "preset"), (False, (3.0, 3.0, 3.0), "random"),
    (True, (-3.0, 2.5, 2.0), "random"), (True, (2.0, -3.2, 2.4), "random")])
def test_render_image_reference_matches_jax(emission, eye, kind):
    """The slice as a whole: render_image with the 4-channel grid, the
    reference medium and a scroll against the JAX jnp sweep's image
    (absorption is the preset's own mode)."""
    grid = _grid4()
    cam_kw = dict(eye=eye, width=96, height=64)
    jcfg = J.RenderConfig(emission=emission, quadrature="sliced")
    tcfg = T.RenderConfig(emission=emission, quadrature="sliced")
    jmed, tmed = J.MediumConfig(density=4.0), T.MediumConfig(density=4.0)
    scroll = _scroll4(kind)
    jplan = jsweep.plan_sweep(J.make_camera(J.CameraConfig(**cam_kw)),
                              grid.shape, jcfg)
    want = np.asarray(jsweep.sweep_render(
        jnp.asarray(grid), jplan, jcfg, jmed, scroll=jnp.asarray(scroll),
        use_pallas=False))
    g = torch.from_numpy(grid)
    got = sweep_render(g, torch_plan(jplan), tcfg, tmed, scroll=scroll)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # through the public entry point with the port's own camera and plan
    # (atol 1e-4: the plans' warp coords differ in float32 atan)
    got = T.render_image(g, T.make_camera(T.CameraConfig(**cam_kw)), tcfg,
                         tmed, scroll=torch.from_numpy(scroll))
    assert got.shape == (64, 96, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4)
    assert float(got[..., 3].max()) > 0.0


@pytest.mark.parametrize("emission", [True, False])
def test_reference_grid_gradient_matches_jax(emission):
    """d/dgrid of sum(rgb^2) through the L build, the plain 4-channel sweep
    and the warp against jax.grad of the same loss."""
    grid = _grid4(seed=3)
    jcfg = J.RenderConfig(emission=emission, quadrature="sliced")
    tcfg = T.RenderConfig(emission=emission, quadrature="sliced")
    jmed, tmed = J.MediumConfig(density=4.0), T.MediumConfig(density=4.0)
    scroll = _scroll4("random")
    jplan = jsweep.plan_sweep(J.make_camera(J.CameraConfig(
        eye=(3.0, 3.0, 3.0), width=96, height=64)), grid.shape, jcfg)

    def loss(g):
        img = jsweep.sweep_render(g, jplan, jcfg, jmed,
                                  scroll=jnp.asarray(scroll),
                                  use_pallas=False)
        return jnp.sum(img[..., :3] ** 2)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.grad(loss)(jnp.asarray(grid)))
    g = torch.from_numpy(grid.copy()).requires_grad_()
    img = sweep_render(g, torch_plan(jplan), tcfg, tmed, scroll=scroll)
    (img[..., :3] ** 2).sum().backward()
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(g.grad.numpy(), want, rtol=RTOL,
                               atol=RTOL * scale)
    for c in range(4):
        assert float(g.grad[..., c].abs().max()) > 0.0


@pytest.mark.parametrize("combine", ["single", "reference"])
def test_backend_reference_matches_jax(cloud, combine):
    """backend="reference" with the sliced quadrature is the per-ray
    oracle render_rays_sliced, as in the JAX package."""
    if combine == "single":
        grid, jmed, tmed, scroll = cloud, J.MediumConfig(
            combine="single", density=8.0), T.MediumConfig(
            combine="single", density=8.0), None
    else:
        grid, jmed, tmed, scroll = _grid4(), J.MediumConfig(density=4.0), \
            T.MediumConfig(density=4.0), _scroll4("random")
    cam_kw = dict(eye=(3.0, 3.0, 3.0), width=48, height=32)
    jcfg = J.RenderConfig(emission=True, quadrature="sliced")
    tcfg = T.RenderConfig(emission=True, quadrature="sliced")
    want = np.asarray(J.render_image(
        jnp.asarray(grid), J.make_camera(J.CameraConfig(**cam_kw)), jcfg,
        jmed, scroll=None if scroll is None else jnp.asarray(scroll),
        backend="reference"))
    tcam = T.make_camera(T.CameraConfig(**cam_kw))
    g = torch.from_numpy(grid.copy())
    got = T.render_image(g, tcam, tcfg, tmed, scroll=scroll,
                         backend="reference")
    assert got.shape == (32, 48, 4)
    # per-pixel rays, no warp: only the cameras' float32 rays differ
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4)
    # and it is the integral the sweep computes, up to the warp's resampling
    swept = T.render_image(g, tcam, tcfg, tmed, scroll=scroll)
    assert float((swept - got).abs().mean()) < 2e-2
