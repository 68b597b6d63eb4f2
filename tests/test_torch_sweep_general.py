"""The port's general sweep (ops/sweep.py _sweep_base) against the JAX
package's jnp sweep, on the configurations no kernel covers: the reference
combine with clamp or wrap addressing, a light volume of another shape than
the grid's, and a light volume with absorption (dropped: never read). Also
composite_base_maps, the split of a sweep into two slice ranges composited
again, and the last functions the port lacked (two_volume_grid,
dequantize_uint8, sample_bilinear_2d).

Tolerances are the JAX tests' own: images rtol=2e-4, atol=2e-5
(tests/test_sweep_pallas.py), gradients rtol=2e-4, atol=2e-4 * max|grad|
(JAX at matmul precision "highest"); the bfloat16 mode rtol = atol = 2e-2
(tests/test_bf16.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from test_torch_sweep_fwd import torch_plan
from volumetricrenderer_tpu.kernels import sweep_pallas as jpallas
from volumetricrenderer_tpu.models import scene as jscene
from volumetricrenderer_tpu.ops import resample as jresample
from volumetricrenderer_tpu.ops import sampling as jsampling
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu_torch.kernels import sweep_fwd
from volumetricrenderer_tpu_torch.models import scene as tscene
from volumetricrenderer_tpu_torch.ops import resample as tresample
from volumetricrenderer_tpu_torch.ops import sampling as tsampling
from volumetricrenderer_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
D = 16
EYES = {"x-": (3.0, 0.4, 0.3), "z+": (0.4, 0.3, -3.0), "y-": (0.3, 3.0, 0.4)}


def _grid4(seed=0):
    return np.random.default_rng(seed).uniform(0.1, 1.0, (D, D, D, 4)) \
        .astype(np.float32)


def _scroll(seed=5):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (4, 3)) \
        .astype(np.float32)


def _case(eye, emission=True, mode="mirror", shape=(D, D, D), dtype=None,
          n_slices=None, width=48, height=32):
    kw = dict(emission=emission, quadrature="sliced", address_mode=mode)
    if dtype:
        kw["dtype"] = dtype
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    jplan = jsweep.plan_sweep(J.make_camera(J.CameraConfig(
        eye=EYES[eye], width=width, height=height)), shape, jcfg,
        n_slices=n_slices)
    return jcfg, tcfg, jplan, torch_plan(jplan)


def _jax(grid, jplan, jcfg, jmed, light=None, scroll=None, lvol=None):
    """The JAX frame and the gradients of sum(rgb^2) to the grid (and the
    light volume), at matmul precision "highest"."""
    def loss(g, lv):
        img = jsweep.sweep_render(g, jplan, jcfg, jmed, light, scroll=scroll,
                                  light_volume=lv)
        return jnp.sum(img[..., :3] ** 2), img

    args = (jnp.asarray(grid), None if lvol is None else jnp.asarray(lvol))
    with jax.default_matmul_precision("highest"):
        (_, img), grads = jax.value_and_grad(
            loss, argnums=(0, 1) if lvol is not None else 0,
            has_aux=True)(*args)
    if lvol is None:
        grads = (grads, None)
    return np.asarray(img), [None if g is None else np.asarray(g)
                             for g in grads]


def _port(grid, tplan, tcfg, tmed, light=None, scroll=None, lvol=None):
    g = torch.from_numpy(grid.copy()).requires_grad_()
    lv = None if lvol is None else \
        torch.from_numpy(lvol.copy()).requires_grad_()
    img = tsweep.sweep_render(g, tplan, tcfg, tmed, light,
                              scroll=None if scroll is None
                              else torch.from_numpy(scroll),
                              light_volume=lv)
    (img[..., :3] ** 2).sum().backward()
    return img.detach().numpy(), [g.grad, None if lv is None else lv.grad]


def _assert_grad(got, want, tol=RTOL):
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("mode", ["clamp", "wrap"])
@pytest.mark.parametrize("emission,eye", [(True, "x-"), (False, "z+"),
                                          (True, "y-")])
def test_reference_clamp_wrap_matches_jax(mode, emission, eye):
    """The reference combine with clamp or wrap addressing and a seeded
    scroll (the scaled and scrolled coordinates leave [0, 1], so the
    address mode matters): frame and grid gradient."""
    grid, scroll = _grid4(), _scroll()
    jcfg, tcfg, jplan, tplan = _case(eye, emission, mode)
    want, (wg, _) = _jax(grid, jplan, jcfg, J.MediumConfig(density=4.0),
                         scroll=jnp.asarray(scroll))
    got, (gg, _) = _port(grid, tplan, tcfg, T.MediumConfig(density=4.0),
                         scroll=scroll)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert float(np.abs(got[..., 3]).max()) > 0.0
    _assert_grad(gg, wg)


@pytest.mark.parametrize("combine,eye,shape", [
    ("single", "x-", (12, 20, 10)), ("single", "z+", (8, 16, 24)),
    ("reference", "y-", (10, 12, 14))])
def test_light_volume_of_another_shape_matches_jax(combine, eye, shape):
    """A light volume whose shape is not the grid's, sampled at its own
    resolution: frame and the gradients to the grid and to the light
    volume."""
    rng = np.random.default_rng(3)
    lvol = rng.uniform(-0.2, 1.3, shape).astype(np.float32)
    light = dict(direction=(0.3, 0.2, 1.0), ambient=0.2)
    if combine == "single":
        grid = _grid4()[..., 0].copy()
        jmed = J.MediumConfig(combine="single", density=8.0)
        tmed = T.MediumConfig(combine="single", density=8.0)
        scroll = None
    else:
        grid, scroll = _grid4(), _scroll()
        jmed, tmed = J.MediumConfig(density=6.0), T.MediumConfig(density=6.0)
    jcfg, tcfg, jplan, tplan = _case(eye)
    want, (wg, wl) = _jax(grid, jplan, jcfg, jmed, J.LightConfig(**light),
                          None if scroll is None else jnp.asarray(scroll),
                          lvol)
    got, (gg, gl) = _port(grid, tplan, tcfg, tmed, T.LightConfig(**light),
                          scroll, lvol)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_grad(gg, wg)
    _assert_grad(gl, wl)


@pytest.mark.parametrize("combine", ["single", "reference"])
def test_light_volume_with_absorption_is_not_read(combine):
    """With absorption the light volume is never read: the frame equals
    the JAX package's (its jnp sweep) and the unlit frame, through the
    kernels' path, and the light volume gets no gradient (JAX's is 0)."""
    if combine == "single":
        grid = _grid4()[..., 0].copy()
        jmed = J.MediumConfig(combine="single", density=8.0)
        tmed = T.MediumConfig(combine="single", density=8.0)
        scroll = None
    else:
        grid, scroll = _grid4(), _scroll()
        jmed, tmed = J.MediumConfig(density=4.0), T.MediumConfig(density=4.0)
    lvol = np.random.default_rng(4).uniform(0.0, 1.0, (D, D, D)) \
        .astype(np.float32)
    jcfg, tcfg, jplan, tplan = _case("x-", emission=False)
    want, (wg, wl) = _jax(grid, jplan, jcfg, jmed, J.LightConfig(),
                          None if scroll is None else jnp.asarray(scroll),
                          lvol)
    assert not np.any(wl)
    got, (gg, gl) = _port(grid, tplan, tcfg, tmed, T.LightConfig(), scroll,
                          lvol)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_grad(gg, wg)
    assert gl is None or not bool(gl.any())
    unlit, _ = _port(grid, tplan, tcfg, tmed, T.LightConfig(), scroll)
    np.testing.assert_array_equal(got, unlit)


def test_reference_clamp_bfloat16_matches_jax():
    """The general sweep in the bfloat16 mode, as the jnp sweep takes it
    (matrices, slab and the product between the matmuls rounded)."""
    grid, scroll = _grid4(1), _scroll(6)
    jcfg, tcfg, jplan, tplan = _case("x-", True, "clamp", dtype="bfloat16")
    want, (wg, _) = _jax(grid, jplan, jcfg, J.MediumConfig(density=4.0),
                         scroll=jnp.asarray(scroll))
    got, (gg, _) = _port(grid, tplan, tcfg, T.MediumConfig(density=4.0),
                         scroll=scroll)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    _assert_grad(gg, wg, tol=2e-2)


def _routes(monkeypatch):
    calls = []
    real = tsweep._sweep_base

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tsweep, "_sweep_base", spy)
    return calls


@pytest.mark.parametrize("combine,mode,emission,light", [
    ("single", "mirror", True, None), ("single", "wrap", True, "same"),
    ("single", "clamp", True, "other"), ("single", "mirror", False, "same"),
    ("reference", "mirror", True, "same"), ("reference", "clamp", True, None),
    ("reference", "wrap", False, None), ("reference", "mirror", False,
                                         "same"),
    ("reference", "mirror", True, "other")])
def test_general_sweep_only_where_the_jax_gate_refuses(monkeypatch, combine,
                                                       mode, emission, light):
    """The port takes the general sweep exactly where the JAX package's
    Pallas gate (with its own light-shape check) sends JAX to the jnp
    sweep, except a light volume with absorption, which JAX sweeps
    without reading it and the port drops before the kernels' gate."""
    grid = _grid4()
    if combine == "single":
        grid = grid[..., 0].copy()
    lvol = {None: None, "same": np.ones((D, D, D), np.float32),
            "other": np.ones((8, 8, 8), np.float32)}[light]
    jcfg, tcfg, jplan, tplan = _case("x-", emission, mode)
    jmed, tmed = J.MediumConfig(combine=combine), \
        T.MediumConfig(combine=combine)
    scroll = _scroll() if combine == "reference" else None
    jax_general = not (
        jpallas.supported(jplan, jcfg, jmed, lvol, scroll, grid.ndim, D)
        and (lvol is None or lvol.shape == grid.shape[:3]))
    if lvol is not None and not emission:
        assert jax_general
        jax_general = not jpallas.supported(jplan, jcfg, jmed, None, scroll,
                                            grid.ndim, D)
    calls = _routes(monkeypatch)
    img = tsweep.sweep_render(
        torch.from_numpy(grid), tplan, tcfg, tmed, T.LightConfig(),
        scroll=None if scroll is None else torch.from_numpy(scroll),
        light_volume=None if lvol is None else torch.from_numpy(lvol))
    assert img.shape == (32, 48, 4)
    assert bool(calls) == jax_general


def test_composite_base_maps_matches_jax():
    rng = np.random.default_rng(7)
    near, far = ([rng.uniform(0.0, 1.0, (6, 5)).astype(np.float32)
                  for _ in range(4)] for _ in range(2))
    want = jsweep.composite_base_maps(tuple(map(jnp.asarray, near)),
                                      tuple(map(jnp.asarray, far)))
    got = tsweep.composite_base_maps(tuple(map(torch.from_numpy, near)),
                                     tuple(map(torch.from_numpy, far)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _halves_and_whole(grid, tplan, tcfg, tmed, kernel_node):
    """The base maps of the whole sweep, and of its two halves of slices
    (front, back) composited, with the grid's gradient of a seeded
    linear loss on each."""
    rng = np.random.default_rng(11)
    cts = [torch.from_numpy(rng.normal(size=tplan.base_shape)
                            .astype(np.float32)) for _ in range(3)]
    S = tplan.slice_z.shape[0]
    out = []
    for split in (False, True):
        g = torch.from_numpy(grid.copy()).requires_grad_()
        gperm = g.permute(tplan.perm)
        if not kernel_node:
            parts = [(tplan.slice_z[:S // 2], None),
                     (tplan.slice_z[S // 2:], None)] if split else \
                [(tplan.slice_z, None)]
            maps = [tsweep._sweep_base(gperm, None, z, tplan.v_grid,
                                       tplan.u_grid, tplan.seglen, tplan,
                                       tcfg, tmed, None, None)
                    for z, _ in parts]
        else:
            # the kernels' node on slabs of the stack in k order, each
            # swept front to back (flipped when sign < 0)
            (stack, slice_z, *rest), flip = sweep_fwd.sweep_inputs(
                gperm, tplan, tcfg, tmed)
            z_k = slice_z if tplan.sign > 0 else slice_z.flip(0)
            n = 2 if split else 1
            blocks = [(stack[i * S // n:(i + 1) * S // n],
                       z_k[i * S // n:(i + 1) * S // n]) for i in range(n)]
            if tplan.sign < 0:
                blocks = blocks[::-1]
            maps = [sweep_fwd._SweepFwd.apply(
                blk, None, z if tplan.sign > 0 else z.flip(0), *rest,
                tcfg.emission, flip, tcfg.address_mode, False)
                for blk, z in blocks]
        whole = maps[0]
        for m in maps[1:]:
            whole = tsweep.composite_base_maps(whole, m)
        sum((m * c).sum() for m, c in zip(whole[:3], cts)).backward()
        out.append(([m.detach() for m in whole], g.grad))
    return out


@pytest.mark.parametrize("kernel_node", [False, True])
@pytest.mark.parametrize("emission,eye", [(True, "x-"), (True, "z+"),
                                          (False, "y-")])
def test_two_halves_composited_equal_the_whole_sweep(kernel_node, emission,
                                                     eye):
    """Sweeping the front and the back half of the slices and compositing
    them equals the whole sweep, forward and gradient (the early-stop gate
    off: it reads a half's own transmittance); through the general sweep
    and through the kernels' autograd node on slabs of the stack."""
    grid = _grid4(2)[..., 0].copy()
    _, tcfg, _, tplan = _case(eye, emission)
    tcfg = dataclasses.replace(tcfg, early_stop_transmittance=-1.0)
    tmed = T.MediumConfig(combine="single", density=8.0)
    (whole, g_whole), (split, g_split) = _halves_and_whole(
        grid, tplan, tcfg, tmed, kernel_node)
    for a, b in zip(split, whole):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    scale = float(g_whole.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(g_split, g_whole, rtol=RTOL,
                               atol=RTOL * scale)


def test_two_volume_grid_matches_jax():
    want = np.asarray(jscene.two_volume_grid(16))
    got = tscene.two_volume_grid(16, device="cpu")
    assert got.shape == (16, 16, 16) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_dequantize_uint8_matches_jax():
    u = np.arange(256, dtype=np.uint8)
    want = np.asarray(jsampling.dequantize_uint8(jnp.asarray(u)))
    got = tsampling.dequantize_uint8(torch.from_numpy(u))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["clamp", "mirror", "wrap"])
@pytest.mark.parametrize("channels", [None, 3])
def test_sample_bilinear_2d_matches_jax(mode, channels):
    rng = np.random.default_rng(12)
    shape = (6, 9) if channels is None else (6, 9, channels)
    img = rng.random(shape).astype(np.float32)
    rows = rng.uniform(-0.3, 1.3, (5, 7)).astype(np.float32)
    cols = rng.uniform(-0.3, 1.3, (5, 7)).astype(np.float32)
    want = np.asarray(jresample.sample_bilinear_2d(
        jnp.asarray(img), jnp.asarray(rows), jnp.asarray(cols), mode))
    got = tresample.sample_bilinear_2d(torch.from_numpy(img),
                                       torch.from_numpy(rows),
                                       torch.from_numpy(cols), mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # exact at texel centers, as tests/test_sweep.py holds the JAX one
    r, c = np.meshgrid((np.arange(6) + 0.5) / 6, (np.arange(9) + 0.5) / 9,
                       indexing="ij")
    centers = tresample.sample_bilinear_2d(
        torch.from_numpy(img), torch.from_numpy(r.astype(np.float32)),
        torch.from_numpy(c.astype(np.float32)), mode)
    np.testing.assert_allclose(centers.numpy(), img, atol=1e-6)
