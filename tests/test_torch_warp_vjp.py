"""The screen warp's adjoint in the PyTorch port (ops/sweep.py
_WarpBilinear) against the JAX package's custom VJP (_warp_bilinear, its
_splat_windowed backward, and warp_band's contract for one band of pixel
rows), against autograd of the plain bilinear gather, and against finite
differences; and the graphs of the training paths, which must hold the
op's node and no index_put_ scatter."""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu.config import CameraConfig as JCameraConfig
from volumetricrenderer_tpu.config import RenderConfig as JRender
from volumetricrenderer_tpu.ops import camera as jcam
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu_torch import CameraConfig, LightConfig, \
    MediumConfig, RenderConfig, VolumeConfig, build_volume, cloud_volume, \
    make_camera, render_image
from volumetricrenderer_tpu_torch.ops import sweep as tsweep
from volumetricrenderer_tpu_torch.ops.integrate import reference_media_scroll
from volumetricrenderer_tpu_torch.ops.resample import sample_bilinear_2d

torch.set_num_threads(1)

GRAD_TOL = 1e-5   # of the largest gradient, as test_warp_custom_vjp_exact


@functools.lru_cache(maxsize=None)
def _jax_plan(eye=(3.0, 3.0, 3.0), width=48, height=32):
    """The JAX plan and a port plan carrying its pixel coordinates: the
    two plans' coordinates differ by float32 atan rounding
    (test_torch_plan.py), and the warp is compared on the same ones."""
    jcfg = JRender(emission=True, quadrature="sliced")
    jplan = jsweep.plan_sweep(
        jcam.make_camera(JCameraConfig(eye=eye, width=width, height=height)),
        (16, 16, 16), jcfg)
    tplan = tsweep.plan_sweep(
        make_camera(CameraConfig(eye=eye, width=width, height=height)),
        (16, 16, 16), RenderConfig(emission=True, quadrature="sliced"))
    tplan = dataclasses.replace(
        tplan, warp_rows01=torch.from_numpy(np.array(jplan.warp_rows01)),
        warp_cols01=torch.from_numpy(np.array(jplan.warp_cols01)))
    return jplan, tplan


def _footprint(plan):
    return (tsweep._in01(plan.warp_rows01)
            & tsweep._in01(plan.warp_cols01)).numpy()


def _port_vjp(base, plan, miss, ct):
    b = torch.from_numpy(base).requires_grad_()
    out = tsweep.warp_base_to_pixels(b, plan, miss=miss)
    grad, = torch.autograd.grad(out, b, torch.from_numpy(ct))
    return out.detach().numpy(), grad.numpy()


def _jax_vjp(base, plan, miss, ct):
    out, vjp = jax.vjp(lambda b: jsweep.warp_base_to_pixels(b, plan,
                                                           miss=miss),
                       jnp.asarray(base))
    grad, = vjp(jnp.asarray(ct))
    return np.asarray(out), np.asarray(grad)


def _close_grad(got, want):
    scale = np.abs(want).max()
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                               atol=GRAD_TOL * scale)


def test_warp_vjp_matches_autograd_of_the_gather():
    """The port of tests/test_sweep.py::test_warp_custom_vjp_exact: the
    written-out adjoint equals autograd of the plain bilinear gather
    (sample_bilinear_2d, clamp) under the same footprint mask."""
    cfg = RenderConfig(emission=True, quadrature="sliced")
    cam = make_camera(CameraConfig(eye=(2.2, 2.8, 2.4), width=40, height=24))
    plan = tsweep.plan_sweep(cam, (10, 10, 10), cfg)
    base = torch.tensor(
        np.random.default_rng(3).random(plan.base_shape + (4,)),
        dtype=torch.float32)
    miss = (0.0, 0.0, 0.0, 1.0)

    def loss_custom(b):
        out = tsweep.warp_base_to_pixels(b, plan, miss=miss)
        return (out ** 2).sum()

    def loss_autodiff(b):
        out = sample_bilinear_2d(b, plan.warp_rows01, plan.warp_cols01,
                                 "clamp")
        inr = (tsweep._in01(plan.warp_rows01)
               & tsweep._in01(plan.warp_cols01))[..., None]
        out = torch.where(inr, out, torch.tensor(miss))
        return (out ** 2).sum()

    b1 = base.clone().requires_grad_()
    b2 = base.clone().requires_grad_()
    l1, l2 = loss_custom(b1), loss_autodiff(b2)
    np.testing.assert_allclose(l1.item(), l2.item(), rtol=1e-6)
    l1.backward()
    l2.backward()
    np.testing.assert_allclose(b1.grad.numpy(), b2.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float(b1.grad.abs().max()) > 0.0


@pytest.mark.parametrize("channels,miss", [
    (None, 0.5), (1, (0.25,)), (2, 0.0), (2, (0.0, 1.0)),
    (4, (0.0, 0.0, 0.0, 1.0)), (4, 0.75)])
def test_warp_vjp_matches_jax(channels, miss):
    """Forward and base cotangent against jax.vjp of the JAX
    warp_base_to_pixels (its custom VJP, _splat_windowed) on the JAX
    plan's own coordinates: a (Hb, Wb) map or 1, 2, 4 channels, a scalar
    or per-channel miss, seeded normal cotangents."""
    jplan, tplan = _jax_plan()
    inside = _footprint(tplan)
    assert inside.any() and not inside.all()   # both sides of the mask
    rng = np.random.default_rng(11)
    shape = jplan.base_shape + (() if channels is None else (channels,))
    base = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    ct = rng.normal(size=tuple(tplan.warp_rows01.shape)
                    + shape[2:]).astype(np.float32)
    got_out, got = _port_vjp(base, tplan, miss, ct)
    want_out, want = _jax_vjp(base, jplan, miss, ct)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-6)
    _close_grad(got, want)


@pytest.mark.parametrize("h0,h1", [(0, 16), (16, 32), (5, 21)])
def test_band_warp_gives_full_base_cotangents(h0, h1):
    """warp_band's contract, as the sharded path gets it from a row-sliced
    plan (parallel/sweep_sharded.local_plan) on the gathered base: a band
    of pixel rows gives the full base's cotangent, equal to the whole
    frame's with the other rows' cotangent zeroed (in the port and through
    JAX's custom VJP)."""
    jplan, tplan = _jax_plan()
    rng = np.random.default_rng(5)
    base = rng.uniform(0.0, 1.0, jplan.base_shape + (2,)).astype(np.float32)
    ct = rng.normal(size=tuple(tplan.warp_rows01.shape) + (2,)) \
        .astype(np.float32)
    band = dataclasses.replace(tplan,
                               warp_rows01=tplan.warp_rows01[h0:h1],
                               warp_cols01=tplan.warp_cols01[h0:h1])
    miss = (0.0, 1.0)
    out, got = _port_vjp(base, band, miss, np.ascontiguousarray(ct[h0:h1]))
    zeroed = np.zeros_like(ct)
    zeroed[h0:h1] = ct[h0:h1]
    full_out, full = _port_vjp(base, tplan, miss, zeroed)
    assert got.shape == base.shape and np.abs(got).max() > 0.0
    np.testing.assert_array_equal(out, full_out[h0:h1])
    np.testing.assert_allclose(got, full, rtol=1e-6, atol=0.0)
    _close_grad(got, _jax_vjp(base, jplan, miss, zeroed)[1])


@pytest.mark.parametrize("miss", [None, (0.0, 1.0)])
def test_warp_vjp_gradcheck_at_the_footprint_edges(miss):
    """Finite differences in float64 on a tiny base, at positions outside
    [0, 1] (clip-then-tent: the edge texel takes the whole weight), on
    its bounds, between the edge texel's center and the bound, and
    inside."""
    tplan = tsweep.plan_sweep(make_camera(CameraConfig(width=8, height=6)),
                              (4, 5, 4), RenderConfig(quadrature="sliced"))
    edges = [-0.3, -1e-3, 0.0, 0.05, 0.1, 0.5, 0.93, 0.97, 1.0, 1.0 + 1e-3,
             1.4]
    rows = torch.tensor(edges, dtype=torch.float64)
    plan = dataclasses.replace(tplan,
                               warp_rows01=rows[:, None].expand(11, 11),
                               warp_cols01=rows[None, :].expand(11, 11))
    base = torch.tensor(np.random.default_rng(2).uniform(0, 1, (5, 4, 2)),
                        dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda b: tsweep.warp_base_to_pixels(b, plan, miss=miss), (base,))


def _names(t):
    seen, out, todo = set(), collections.Counter(), [t.grad_fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        out[type(f).__name__] += 1
        todo.extend(n for n, _ in f.next_functions)
    return out


@pytest.mark.parametrize("path", ["flagship", "config4", "reference"])
def test_training_graph_has_no_scatter(path):
    """A training step's graph at small size (the flagship's medium, with
    config 4's shadows, and the 4-channel reference medium) holds the
    warp's node once and no advanced-indexing backward, whose CUDA form
    is index_put_ with accumulate."""
    cam = make_camera(CameraConfig(width=48, height=32))
    cfg = RenderConfig(emission=True, quadrature="sliced")
    if path == "reference":
        g = build_volume(VolumeConfig(size=16), device="cpu")
        kw = dict(medium=MediumConfig(), scroll=reference_media_scroll(0.0))
    else:
        g = cloud_volume(16, 7, device="cpu")
        kw = dict(medium=MediumConfig(combine="single", density=8.0),
                  light=LightConfig(shadow_steps=8)
                  if path == "config4" else None)
    g.requires_grad_()
    img = render_image(g, cam, cfg, **kw)
    names = _names((img[..., :3] ** 2).sum())
    assert names["_WarpBilinearBackward"] == 1, names
    # index_select's backward is index_add_, not the sort-based scatter
    assert not {n for n in names if n.startswith("Index")} \
        - {"IndexSelectBackward0"}, names
