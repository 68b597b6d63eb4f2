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
    """bench.py's validate_gradients in the port, without JAX: the sweep's
    grid gradient on an identity-warp plan (base maps = image) against the
    per-ray oracle on the base rays, cloud_volume(24, 7) at 48x32, with
    bench.py's allclose(rtol=1e-3, atol=1e-3 * scale)."""
    cfg = T.RenderConfig(emission=True, quadrature="sliced")
    medium = T.MediumConfig(combine="single", density=8.0)
    cam = T.make_camera(T.CameraConfig(width=48, height=32))
    grid = T.cloud_volume(24, 7)
    plan = T.plan_for(cam, grid.shape, cfg)
    plan_base = dataclasses.replace(plan, identity_warp=True)
    o, d = tsweep.base_rays(plan)

    g1 = grid.clone().requires_grad_()
    (tsweep.sweep_render(g1, plan_base, cfg, medium)[..., :3] ** 2).sum() \
        .backward()
    g2 = grid.clone().requires_grad_()
    (tint.render_rays_sliced(g2, o, d, plan, cfg, medium)[..., :3] ** 2) \
        .sum().backward()
    scale = float(g2.grad.abs().max())
    assert scale > 0.0
    assert torch.allclose(g1.grad, g2.grad, rtol=1e-3, atol=1e-3 * scale)


def test_unported_paths_raise():
    grid, o, d, jcfg, jmed, tcfg, tmed = _march_setup(True)
    g, o, d = _t(grid), _t(o), _t(d)
    with pytest.raises(NotImplementedError, match="reference combine"):
        tint.render_rays(g, o, d, tcfg, T.MediumConfig())
    with pytest.raises(NotImplementedError, match="shadow"):
        tint.render_rays(g, o, d, tcfg, tmed, T.LightConfig(shadow_steps=4))
    with pytest.raises(NotImplementedError, match="scene_sigma"):
        tint.scene_sigma([], o, tcfg, tmed)
    with pytest.raises(NotImplementedError):
        tint.reference_media_scroll(1.0)
    _, so, sd, _, _, _, tplan, scfg, smed = _sliced_setup(EYES[0][0], True)
    with pytest.raises(NotImplementedError, match="light volume"):
        tint.render_rays_sliced(g, _t(so), _t(sd), tplan, scfg, smed,
                                light_volume=g)
