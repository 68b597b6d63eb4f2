"""The port's forward render as a whole against the JAX package's jnp sweep
(`sweep_render(..., use_pallas=False)`) on the FBM cloud, and the plain
sweep's grid gradient against jax.grad of the same loss; the same for the
reference medium and for shadowed frames (config 4's light volume)."""
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
from volumetricrenderer_tpu_torch.ops.integrate import render_rays_sliced
from volumetricrenderer_tpu_torch.ops.sweep import base_rays, sweep_render

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
    plan = T.plan_for(tcam, grid.shape, tcfg, device="cpu")
    torch.testing.assert_close(
        T.render(grid, tcam, tcfg, tmed, backend="pallas", plan=plan), auto)
    with pytest.raises(ValueError, match="unknown backend"):
        T.render_image(grid, tcam, tcfg, tmed, backend="swep")
    # the "fixed" quadrature is the per-ray march, whatever the backend but
    # "sweep" (test_torch_preset.py holds it to the JAX package)
    fixed = dataclasses.replace(tcfg, quadrature="fixed")
    small = T.make_camera(T.CameraConfig(width=12, height=8))
    marched = T.render_image(grid, small, fixed, tmed, backend="reference")
    assert marched.shape == (8, 12, 4)
    torch.testing.assert_close(T.render_image(grid, small, fixed, tmed),
                               marched, rtol=0, atol=0)
    with pytest.raises(ValueError, match="sliced"):
        T.render_image(grid, tcam, fixed, tmed, backend="sweep")
    # the reference combine needs a 4-D grid; the single combine takes
    # channel 0 of a (D, H, W, C) grid
    with pytest.raises(NotImplementedError):
        T.render_image(grid, tcam, tcfg, T.MediumConfig(), plan=plan)
    torch.testing.assert_close(
        T.render_image(grid[..., None], tcam, tcfg, tmed, plan=plan), auto,
        rtol=0, atol=0)
    grid4 = grid[..., None].expand(-1, -1, -1, 4)
    # a light volume must be 3-D (one of another shape, or one with
    # absorption, renders: test_repaired_configurations_match_jax)
    with pytest.raises(NotImplementedError, match="light volume"):
        T.render_image(grid4, tcam, tcfg, T.MediumConfig(), plan=plan,
                       light_volume=grid4)
    # bfloat16 is a stream mode of the sweep now; no other type is
    with pytest.raises(NotImplementedError, match="float16"):
        T.render_image(grid4, tcam,
                       dataclasses.replace(tcfg, dtype="float16"),
                       T.MediumConfig(), plan=plan)
    low = T.render_image(grid, tcam, dataclasses.replace(tcfg,
                                                         dtype="bfloat16"),
                         tmed, plan=plan)
    assert low.dtype == torch.float32
    assert 0.0 < float((low - auto).abs().max()) < 3e-2
    # shadows with the "fixed" quadrature: the march casts its own shadow
    # rays and builds no light volume
    shadowed = T.render_image(grid, small, fixed, tmed,
                              light=T.LightConfig(shadow_steps=4))
    assert bool((shadowed[..., :3] <= marched[..., :3] + 1e-6).all())
    assert float((marched[..., :3] - shadowed[..., :3]).max()) > 1e-3


@pytest.mark.parametrize("case", ["reference, light of another shape",
                                  "absorption with a light volume"])
def test_repaired_configurations_match_jax(cloud, case):
    """Two configurations the port once refused and the JAX package
    renders: the reference medium shaded by a light volume of another shape
    than the grid's (the general sweep), and a light volume with
    absorption (never read). Frame against the JAX render_image on the same
    grid, camera and light volume."""
    jcfg, jmed, jcam, tcfg, tmed, tcam = _configs(True)
    lvol = cloud[:-1].copy()
    grid = cloud[..., None].repeat(4, axis=-1).copy()
    jmed, tmed = J.MediumConfig(density=4.0), T.MediumConfig(density=4.0)
    if case.startswith("absorption"):
        jcfg = dataclasses.replace(jcfg, emission=False)
        tcfg = dataclasses.replace(tcfg, emission=False)
        grid, lvol = cloud.copy(), cloud.copy()
        jmed = J.MediumConfig(combine="single", density=8.0)
        tmed = T.MediumConfig(combine="single", density=8.0)
    jplan = jsweep.plan_sweep(jcam, cloud.shape, jcfg)
    want = np.asarray(jsweep.sweep_render(
        jnp.asarray(grid), jplan, jcfg, jmed, light_volume=jnp.asarray(lvol),
        use_pallas=False))
    got = T.render_image(torch.from_numpy(grid), tcam, tcfg, tmed,
                         plan=torch_plan(jplan),
                         light_volume=torch.from_numpy(lvol))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert float(got[..., 3].max()) > 0.0


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


@pytest.mark.parametrize("combine,eye", [("single", (3.0, 3.0, 3.0)),
                                         ("single", (-2.5, 0.8, -1.0)),
                                         ("reference", (2.0, -3.2, 2.4))])
def test_render_image_with_shadows_matches_jax(cloud, combine, eye):
    """The light-volume slice as a whole: render_image with
    LightConfig(shadow_steps=32) builds the light volume from the grid and
    sweeps with it, against the JAX render_image (the jnp sweep on the
    CPU), forward and the gradient of sum(rgb^2) to the grid, which runs
    through dG and through dL and the light sweep."""
    if combine == "single":
        grid, scroll = cloud[::2, ::2, ::2].copy(), None
        jmed = J.MediumConfig(combine="single", density=8.0)
        tmed = T.MediumConfig(combine="single", density=8.0)
    else:
        grid, scroll = _grid4(seed=1), _scroll4("random")
        jmed, tmed = J.MediumConfig(density=6.0), T.MediumConfig(density=6.0)
    cam_kw = dict(eye=eye, width=96, height=64)
    jcfg = J.RenderConfig(emission=True, quadrature="sliced")
    tcfg = T.RenderConfig(emission=True, quadrature="sliced")
    jlight, tlight = J.LightConfig(shadow_steps=32), \
        T.LightConfig(shadow_steps=32)
    jcam = J.make_camera(J.CameraConfig(**cam_kw))
    jplan = jsweep.plan_sweep(jcam, grid.shape, jcfg)
    jscroll = None if scroll is None else jnp.asarray(scroll)

    def jloss(g):
        img = J.render_image(g, jcam, jcfg, jmed, jlight, scroll=jscroll,
                             plan=jplan)
        return jnp.sum(img[..., :3] ** 2), img
    with jax.default_matmul_precision("highest"):
        (_, want), gwant = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(grid))
    want, gwant = np.asarray(want), np.asarray(gwant)
    g = torch.from_numpy(grid.copy()).requires_grad_()
    tcam = T.make_camera(T.CameraConfig(**cam_kw))
    got = T.render_image(g, tcam, tcfg, tmed, tlight, scroll=scroll,
                         plan=torch_plan(jplan))
    (got[..., :3] ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    scale = float(np.abs(gwant).max())
    assert scale > 0.0
    np.testing.assert_allclose(g.grad.numpy(), gwant, rtol=RTOL,
                               atol=RTOL * scale)
    # with the port's own plan (atol 1e-4: the plans' warp coords differ in
    # float32 atan), and against the unshadowed frame: shadows only darken
    with torch.no_grad():
        own = T.render_image(g, tcam, tcfg, tmed, tlight, scroll=scroll)
        lit = T.render_image(g, tcam, tcfg, tmed, scroll=scroll)
    np.testing.assert_allclose(own.numpy(), want, rtol=RTOL, atol=1e-4)
    assert bool((own[..., :3] <= lit[..., :3] + 1e-6).all())
    torch.testing.assert_close(own[..., 3], lit[..., 3], rtol=0, atol=1e-6)
    assert float((lit[..., :3] - own[..., :3]).max()) > 1e-3


def test_shaded_sweep_matches_oracle():
    """tests/test_lighting.py's test_shaded_render_sweep_matches_oracle in
    the port: the sweep on an identity-warp plan and the per-ray oracle
    sample the same light volume; and backend="reference" of render_image
    builds and passes it."""
    grid = torch.from_numpy(np.array(J.cloud_volume(12, 3)))
    cfg = T.RenderConfig(emission=True, quadrature="sliced")
    medium = T.MediumConfig(combine="single", density=6.0)
    light = T.LightConfig(direction=(0.4, 0.2, 1.0), ambient=0.2,
                          shadow_steps=1)
    L = T.light_transmittance_volume(grid, light, cfg, medium)
    cam = T.make_camera(T.CameraConfig(eye=(2.5, 2.2, 2.8), width=24,
                                       height=16))
    plan = T.plan_for(cam, grid.shape, cfg, device="cpu")
    got = sweep_render(grid, dataclasses.replace(plan, identity_warp=True),
                       cfg, medium, light, light_volume=L)
    o, d = base_rays(plan)
    want = render_rays_sliced(grid, o, d, plan, cfg, medium, light,
                              light_volume=L)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    per_ray = T.render_image(grid, cam, cfg, medium, light,
                             backend="reference", plan=plan)
    o, d = T.camera_rays(cam)
    torch.testing.assert_close(
        per_ray, render_rays_sliced(grid, o, d, plan, cfg, medium, light,
                                    light_volume=L), rtol=0, atol=0)
