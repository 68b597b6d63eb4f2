"""The port's per-ray integrators and their leaf ops (ops/aabb.py,
ops/sampling.sample_trilinear, ops/sweep.base_rays, ops/integrate.py)
against the JAX package on the same seeded inputs, and bench.py's gradient
check run inside the port on the CPU: the plain sweep's grid gradient
against the per-ray oracle's.

Tolerances: leaf ops are elementwise float32 with the same expression
order, held to rtol=1e-6, atol=1e-6; the marches compound up to 64 steps
of exp and products, held to rtol=2e-4, atol=2e-5 as the sweep is
(tests/test_sweep_pallas.py); gradients to atol=2e-4 * max|grad|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from test_torch_sweep_fwd import EYES, torch_plan
from volumetricrenderer_tpu.ops import aabb as jaabb
from volumetricrenderer_tpu.ops import integrate as jint
from volumetricrenderer_tpu.ops import sampling as jsamp
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu.ops.lighting import \
    light_transmittance_volume as jlight_volume
from volumetricrenderer_tpu_torch import bench as tbench
from volumetricrenderer_tpu_torch.ops import aabb as taabb
from volumetricrenderer_tpu_torch.ops import integrate as tint
from volumetricrenderer_tpu_torch.ops import sampling as tsamp
from volumetricrenderer_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _rays(n=64, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:8, 0] = 0.0  # rays in a slab plane: the signed-eps guard
    d[8:12, 1] = -0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_intersect_aabb_matches_jax():
    o, d = _rays()
    lo, hi = np.array([-1.0, -0.5, -1.0]), np.array([1.0, 0.7, 1.0])
    got = taabb.intersect_aabb(_t(o), _t(d), lo, hi)
    want = jaabb.intersect_aabb(jnp.asarray(o), jnp.asarray(d), lo, hi)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["mirror", "clamp", "wrap"])
@pytest.mark.parametrize("channels", [None, 3])
def test_sample_trilinear_matches_jax(mode, channels):
    rng = np.random.default_rng(1)
    shape = (6, 7, 5) + ((channels,) if channels else ())
    grid = rng.uniform(size=shape).astype(np.float32)
    coords = rng.uniform(-0.3, 1.3, (4, 9, 3)).astype(np.float32)
    got = tsamp.sample_trilinear(_t(grid), _t(coords), mode)
    want = jsamp.sample_trilinear(jnp.asarray(grid), jnp.asarray(coords),
                                  mode)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("eye,axis,sign", EYES)
def test_base_rays_match_jax(eye, axis, sign):
    jplan = jsweep.plan_sweep(J.make_camera(J.CameraConfig(
        eye=eye, width=48, height=32)), (12, 12, 12),
        J.RenderConfig(emission=True, quadrature="sliced"))
    got = tsweep.base_rays(torch_plan(jplan))
    want = jsweep.base_rays(jplan)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (*jplan.base_shape, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _march_setup(emission, seed=2):
    grid = np.random.default_rng(seed).uniform(0.0, 1.0, (10, 10, 10)) \
        .astype(np.float32)
    cam_kw = dict(eye=(2.6, -1.9, 1.4), width=24, height=16)
    kw = dict(emission=emission, max_steps=48, step_size=4.0 / 48.0)
    jo, jd = J.camera_rays(J.make_camera(J.CameraConfig(**cam_kw)))
    return (grid, np.asarray(jo), np.asarray(jd), J.RenderConfig(**kw),
            J.MediumConfig(combine="single", density=4.0),
            T.RenderConfig(**kw),
            T.MediumConfig(combine="single", density=4.0))


@pytest.mark.parametrize("emission", [True, False])
@pytest.mark.parametrize("w2l", [False, True])
def test_render_rays_matches_jax(emission, w2l):
    grid, o, d, jcfg, jmed, tcfg, tmed = _march_setup(emission)
    m = None
    if w2l:  # a rotation about z plus a translation
        c, s = np.cos(0.4), np.sin(0.4)
        m = np.array([[c, -s, 0, 0.1], [s, c, 0, -0.2], [0, 0, 1, 0.05],
                      [0, 0, 0, 1]], np.float32)
    got = tint.render_rays(_t(grid), _t(o), _t(d), tcfg, tmed,
                           world_to_local=m)
    want = jint.render_rays(jnp.asarray(grid), jnp.asarray(o),
                            jnp.asarray(d), jcfg, jmed, world_to_local=m)
    assert tuple(got.shape) == want.shape == (16, 24, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(got[..., 3].max()) > 0.0


@pytest.mark.parametrize("emission", [True, False])
def test_render_rays_grad_matches_jax(emission):
    grid, o, d, jcfg, jmed, tcfg, tmed = _march_setup(emission, seed=5)
    g = _t(grid).requires_grad_()
    (tint.render_rays(g, _t(o), _t(d), tcfg, tmed)[..., :3] ** 2).sum() \
        .backward()
    want = np.asarray(jax.grad(lambda x: jnp.sum(jint.render_rays(
        x, jnp.asarray(o), jnp.asarray(d), jcfg, jmed)[..., :3] ** 2))(
            jnp.asarray(grid)))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(g.grad.numpy(), want, rtol=RTOL,
                               atol=2e-4 * scale)


def _sliced_setup(eye, emission, seed=3):
    grid = np.random.default_rng(seed).uniform(0.2, 1.0, (12, 12, 12)) \
        .astype(np.float32)
    jcfg = J.RenderConfig(emission=emission, quadrature="sliced")
    jplan = jsweep.plan_sweep(J.make_camera(J.CameraConfig(
        eye=eye, width=48, height=32)), grid.shape, jcfg)
    o, d = (np.asarray(x) for x in jsweep.base_rays(jplan))
    return (grid, o, d, jplan, jcfg,
            J.MediumConfig(combine="single", density=8.0), torch_plan(jplan),
            T.RenderConfig(emission=emission, quadrature="sliced"),
            T.MediumConfig(combine="single", density=8.0))


@pytest.mark.parametrize("eye,emission", [(EYES[0][0], True),
                                          (EYES[4][0], True),
                                          (EYES[2][0], False)])
def test_render_rays_sliced_matches_jax(eye, emission):
    grid, o, d, jplan, jcfg, jmed, tplan, tcfg, tmed = _sliced_setup(
        eye, emission)
    g = _t(grid).requires_grad_()
    got = tint.render_rays_sliced(g, _t(o), _t(d), tplan, tcfg, tmed)
    (got[..., :3] ** 2).sum().backward()

    def jloss(x):
        img = jint.render_rays_sliced(x, jnp.asarray(o), jnp.asarray(d),
                                      jplan, jcfg, jmed)
        return jnp.sum(img[..., :3] ** 2), img
    (_, want), gwant = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(grid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    scale = float(np.abs(gwant).max())
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(gwant), rtol=RTOL,
                               atol=2e-4 * scale)


def test_bench_gradient_check():
    """bench.py's validate_gradients in the port, without JAX
    (volumetricrenderer_tpu_torch/bench.py validate_gradients, which the
    port's bench and chip_smoke.py run): the sweep's grid gradient on an
    identity-warp plan (base maps = image) against the per-ray oracle on
    the base rays, cloud_volume(24, 7) at 48x32, with bench.py's
    allclose(rtol=1e-3, atol=1e-3 * scale)."""
    ok, err, scale = tbench.validate_gradients(torch.device("cpu"))
    assert scale > 0.0
    assert ok, f"max abs err {err:.3e} at scale {scale:.3e}"


def _scroll4(kind):
    if kind == "none":
        return None
    if kind == "preset":
        return np.array(jint.reference_media_scroll(1.7))
    return np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("kind", ["none", "preset", "random"])
def test_sample_sigma_reference_matches_jax(kind):
    """The 4-channel combine at per-channel scaled and scrolled coords;
    positions beyond [0, 1] exercise the mirror."""
    rng = np.random.default_rng(4)
    grid = rng.uniform(size=(6, 7, 5, 4)).astype(np.float32)
    pos = rng.uniform(-0.2, 1.2, (11, 9, 3)).astype(np.float32)
    scroll = _scroll4(kind)
    got = tint.sample_sigma(_t(grid), _t(pos), T.MediumConfig(), scroll,
                            "mirror")
    want = jint.sample_sigma(jnp.asarray(grid), jnp.asarray(pos),
                             J.MediumConfig(),
                             None if scroll is None else jnp.asarray(scroll),
                             "mirror")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="4"):
        tint.sample_sigma(_t(grid[..., 0]), _t(pos), T.MediumConfig(), None,
                          "mirror")


@pytest.mark.parametrize("eye,emission,kind", [
    (EYES[0][0], True, "random"), (EYES[2][0], False, "random"),
    (EYES[3][0], True, "preset"), (EYES[4][0], False, "none")])
def test_render_rays_sliced_reference_matches_jax(eye, emission, kind):
    """The oracle with a (D, H, W, 4) grid and a scroll, forward and grid
    gradient: what the 4-channel kernels' gradient check is held to."""
    grid = np.random.default_rng(3).uniform(0.2, 1.0, (12, 12, 12, 4)) \
        .astype(np.float32)
    jcfg = J.RenderConfig(emission=emission, quadrature="sliced")
    tcfg = T.RenderConfig(emission=emission, quadrature="sliced")
    jmed, tmed = J.MediumConfig(density=6.0), T.MediumConfig(density=6.0)
    jplan = jsweep.plan_sweep(J.make_camera(J.CameraConfig(
        eye=eye, width=48, height=32)), grid.shape, jcfg)
    o, d = (np.asarray(x) for x in jsweep.base_rays(jplan))
    scroll = _scroll4(kind)
    g = _t(grid).requires_grad_()
    got = tint.render_rays_sliced(g, _t(o), _t(d), torch_plan(jplan), tcfg,
                                  tmed, scroll=scroll)
    (got[..., :3] ** 2).sum().backward()

    def jloss(x):
        img = jint.render_rays_sliced(
            x, jnp.asarray(o), jnp.asarray(d), jplan, jcfg, jmed,
            scroll=None if scroll is None else jnp.asarray(scroll))
        return jnp.sum(img[..., :3] ** 2), img
    (_, want), gwant = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(grid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    scale = float(np.abs(gwant).max())
    assert scale > 0.0
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(gwant), rtol=RTOL,
                               atol=2e-4 * scale)


def test_bench_gradient_check_reference():
    """The gradient check with the 4-channel medium and a scroll whose
    offsets are nonzero: the plain 4-channel sweep's grid gradient on an
    identity-warp plan against the per-ray oracle's."""
    cfg = T.RenderConfig(emission=True, quadrature="sliced")
    medium = T.MediumConfig(density=8.0)
    cam = T.make_camera(T.CameraConfig(width=48, height=32))
    grid = _t(np.random.default_rng(2).uniform(0.1, 1.0, (12, 12, 12, 4))
              .astype(np.float32))
    scroll = _scroll4("random")
    plan = T.plan_for(cam, grid.shape, cfg, device="cpu")
    o, d = tsweep.base_rays(plan)
    g1 = grid.clone().requires_grad_()
    (tsweep.sweep_render(g1, dataclasses.replace(plan, identity_warp=True),
                         cfg, medium, scroll=scroll)[..., :3] ** 2).sum() \
        .backward()
    g2 = grid.clone().requires_grad_()
    (tint.render_rays_sliced(g2, o, d, plan, cfg, medium,
                             scroll=scroll)[..., :3] ** 2).sum().backward()
    scale = float(g2.grad.abs().max())
    assert scale > 0.0
    assert torch.allclose(g1.grad, g2.grad, rtol=1e-3, atol=1e-3 * scale)


def test_light_transmittance_matches_jax():
    """The nested shadow march: 6 steps toward an oblique light from
    seeded positions in and around the box, single and reference medium."""
    rng = np.random.default_rng(6)
    pos = rng.uniform(-0.1, 1.1, (7, 9, 3)).astype(np.float32)
    kw = dict(direction=(0.4, -0.3, 1.0), shadow_steps=6,
              shadow_step_size=0.11)
    for grid, jmed, tmed, scroll in (
            (rng.uniform(size=(8, 9, 7)).astype(np.float32),
             J.MediumConfig(combine="single", density=5.0),
             T.MediumConfig(combine="single", density=5.0), None),
            (rng.uniform(size=(8, 9, 7, 4)).astype(np.float32),
             J.MediumConfig(density=5.0), T.MediumConfig(density=5.0),
             _scroll4("random"))):
        got = tint._light_transmittance(_t(grid), _t(pos), tmed, scroll,
                                        T.RenderConfig(),
                                        T.LightConfig(**kw))
        want = jint._light_transmittance(
            jnp.asarray(grid), jnp.asarray(pos), jmed,
            None if scroll is None else jnp.asarray(scroll),
            J.RenderConfig(), J.LightConfig(**kw))
        assert tuple(got.shape) == want.shape == (7, 9)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        assert float(got.min()) < 0.9 and float(got.max()) <= 1.0


def test_render_rays_with_shadows_matches_jax():
    """render_rays with shadow_steps=4, forward and grid gradient: the
    gradient also flows through every nested march (this path has no
    clip)."""
    grid, o, d, jcfg, jmed, tcfg, tmed = _march_setup(True, seed=5)
    kw = dict(shadow_steps=4, shadow_step_size=0.15, ambient=0.2)
    g = _t(grid).requires_grad_()
    got = tint.render_rays(g, _t(o), _t(d), tcfg, tmed, T.LightConfig(**kw))
    (got[..., :3] ** 2).sum().backward()

    def jloss(x):
        img = jint.render_rays(x, jnp.asarray(o), jnp.asarray(d), jcfg, jmed,
                               J.LightConfig(**kw))
        return jnp.sum(img[..., :3] ** 2), img
    (_, want), gwant = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(grid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    scale = float(np.abs(gwant).max())
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(gwant), rtol=RTOL,
                               atol=2e-4 * scale)
    unlit = tint.render_rays(_t(grid), _t(o), _t(d), tcfg, tmed,
                             T.LightConfig(ambient=0.2))
    assert float((unlit[..., :3] - got[..., :3].detach()).max()) > 1e-3


@pytest.mark.parametrize("eye,stretched", [(EYES[0][0], False),
                                           (EYES[4][0], True)])
def test_render_rays_sliced_light_volume_matches_jax(eye, stretched):
    """The oracle with a light volume, forward and both gradients; the
    light volume is the real one (exactly 1.0 where fully lit) or that
    stretched to [-0.2, 1.3], which the clip cuts on both sides."""
    grid, o, d, jplan, jcfg, jmed, tplan, tcfg, tmed = _sliced_setup(
        eye, True)
    kw = dict(ambient=0.2, shadow_steps=32)
    lvol = np.array(jlight_volume(jnp.asarray(grid), J.LightConfig(**kw),
                                  jcfg, jmed))
    if stretched:
        lvol = 1.5 * (lvol - lvol.min()) / (1.0 - lvol.min()) - 0.2
    g, lv = _t(grid).requires_grad_(), _t(lvol).requires_grad_()
    got = tint.render_rays_sliced(g, _t(o), _t(d), tplan, tcfg, tmed,
                                  T.LightConfig(**kw), light_volume=lv)
    (got[..., :3] ** 2).sum().backward()

    def jloss(x, l):
        img = jint.render_rays_sliced(x, jnp.asarray(o), jnp.asarray(d),
                                      jplan, jcfg, jmed, J.LightConfig(**kw),
                                      light_volume=l)
        return jnp.sum(img[..., :3] ** 2), img
    (_, want), (gwant, lwant) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(grid),
                                             jnp.asarray(lvol))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for mine, theirs in ((g.grad, gwant), (lv.grad, lwant)):
        scale = float(np.abs(theirs).max())
        assert scale > 0.0
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=RTOL, atol=2e-4 * scale)


@pytest.mark.parametrize("combine", ["single", "reference"])
def test_bench_gradient_check_with_shadows(combine):
    """bench.py's gradient check with shadows: the light volume is built
    from the grid inside the loss, so the gradient reaches the grid through
    dG and through dL and the light sweep; the plain sweep on an
    identity-warp plan against the per-ray oracle."""
    cfg = T.RenderConfig(emission=True, quadrature="sliced")
    light = T.LightConfig(shadow_steps=32)
    cam = T.make_camera(T.CameraConfig(width=48, height=32))
    if combine == "single":
        medium = T.MediumConfig(combine="single", density=8.0)
        grid, scroll = T.cloud_volume(16, 7, device="cpu"), None
    else:
        medium = T.MediumConfig(density=8.0)
        grid = _t(np.random.default_rng(2).uniform(0.1, 1.0, (12, 12, 12, 4))
                  .astype(np.float32))
        scroll = _scroll4("random")
    plan = T.plan_for(cam, grid.shape, cfg, device="cpu")
    o, d = tsweep.base_rays(plan)

    def lvol(g):
        return T.light_transmittance_volume(g, light, cfg, medium,
                                            scroll=scroll)
    g1 = grid.clone().requires_grad_()
    (tsweep.sweep_render(g1, dataclasses.replace(plan, identity_warp=True),
                         cfg, medium, light, scroll=scroll,
                         light_volume=lvol(g1))[..., :3] ** 2).sum() \
        .backward()
    g2 = grid.clone().requires_grad_()
    (tint.render_rays_sliced(g2, o, d, plan, cfg, medium, light,
                             scroll=scroll,
                             light_volume=lvol(g2))[..., :3] ** 2).sum() \
        .backward()
    scale = float(g2.grad.abs().max())
    assert scale > 0.0
    assert torch.allclose(g1.grad, g2.grad, rtol=1e-3, atol=1e-3 * scale)
    # the light path carries gradient of its own
    g3 = grid.clone().requires_grad_()
    (tsweep.sweep_render(g3, dataclasses.replace(plan, identity_warp=True),
                         cfg, medium, light, scroll=scroll,
                         light_volume=lvol(grid))[..., :3] ** 2).sum() \
        .backward()
    assert float((g1.grad - g3.grad).abs().max()) > 1e-3 * scale


def test_unported_paths_raise():
    grid, o, d, jcfg, jmed, tcfg, tmed = _march_setup(True)
    g, o, d = _t(grid), _t(o), _t(d)
    with pytest.raises(ValueError, match="reference combine"):
        tint.render_rays(g, o, d, tcfg, T.MediumConfig())
    # the shadow march samples the same medium: a 3-D grid has no
    # reference combine
    with pytest.raises(ValueError, match="reference combine"):
        tint.render_rays(g, o, d, tcfg, T.MediumConfig(),
                         T.LightConfig(shadow_steps=4))
    # a scene's volumes sample the same medium
    with pytest.raises(ValueError, match="reference combine"):
        tint.scene_sigma([T.models.scene.Volume(g)], o, tcfg,
                         T.MediumConfig())
    with pytest.raises(ValueError, match="unknown combine"):
        tint._light_transmittance(
            g, o, dataclasses.replace(tmed, combine="other"), None, tcfg,
            T.LightConfig(shadow_steps=2))
    # the sweep reads a light volume with emission only (absorption has no
    # in-scatter to shade): with absorption it is not read, as in the JAX
    # package's jnp sweep, and the frame is the unlit one
    sgrid, _, _, _, _, _, tplan, _, smed = _sliced_setup(EYES[0][0], False)
    acfg = T.RenderConfig(emission=False, quadrature="sliced")
    torch.testing.assert_close(
        tsweep.sweep_render(_t(sgrid), tplan, acfg, smed,
                            light_volume=_t(sgrid)),
        tsweep.sweep_render(_t(sgrid), tplan, acfg, smed), rtol=0, atol=0)
