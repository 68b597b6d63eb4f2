"""The light volume of the port (ops/lighting.light_transmittance_volume,
ops/media.materialize_sigma, the "zero" address mode of
ops/resample.linear_resample_matrix and ops/sampling.clip_unit) against the
JAX package on the same seeded inputs.

Tolerances: the resample matrices are elementwise float32 in the same
expression order, held to atol=1e-6; the light sweep compounds up to 15
shear steps of two small matmuls and one exp, held to rtol=1e-5, atol=1e-6;
gradients to rtol=2e-4, atol=2e-4 * max|grad|, as the sweep's are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from volumetricrenderer_tpu.ops.lighting import \
    light_transmittance_volume as jlight_volume
from volumetricrenderer_tpu.ops.media import \
    materialize_sigma as jmaterialize_sigma
from volumetricrenderer_tpu.ops.resample import \
    linear_resample_matrix as jresample_matrix
from volumetricrenderer_tpu_torch.ops.resample import linear_resample_matrix
from volumetricrenderer_tpu_torch.ops.sampling import clip_unit, \
    clip_unit_grad

torch.set_num_threads(1)

# Light directions on all three dominant axes, both signs; the first is
# LightConfig's default, config 4's.
DIRECTIONS = [(0.5, 0.5, 1.0), (0.3, -0.2, -1.0), (1.0, 0.3, 0.2),
              (-1.0, 0.25, -0.4), (0.2, 1.0, 0.3), (0.4, -1.0, -0.1)]
SHAPE = (10, 12, 14)  # (D, H, W), all different: the permutes are visible


def _scroll():
    return np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("mode", ["zero", "mirror", "clamp", "wrap"])
@pytest.mark.parametrize("zero_outside", [False, True])
def test_resample_matrix_matches_jax(mode, zero_outside):
    """Positions from two texels below the support to two above: in "zero"
    mode a tap beyond [0, n) weighs nothing, so the rows fade out."""
    n = 9
    u01 = np.concatenate([
        np.random.default_rng(0).uniform(-0.25, 1.25, 40),
        [0.0, 1.0, 0.5 / n, 1.0 - 0.5 / n, -0.5 / n, 1.0 + 0.5 / n]]) \
        .astype(np.float32)
    got = linear_resample_matrix(torch.from_numpy(u01), n, mode,
                                 zero_outside=zero_outside).numpy()
    want = np.asarray(jresample_matrix(jnp.asarray(u01), n, mode,
                                       zero_outside=zero_outside))
    assert got.shape == (u01.size, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if mode == "zero":
        sums = got.sum(1)
        assert sums.max() <= 1.0 + 1e-6
        assert np.all(sums[u01 < -0.5 / n - 1e-6] < 1.0)
        assert np.all(sums[u01 > 1.0 + 1.5 / n] == 0.0)


def _both_lights(grid, direction, combine, scroll=None, density=6.0,
                 box=None):
    kw = {} if box is None else dict(box_min=box[0], box_max=box[1])
    jmed = J.MediumConfig(combine=combine, density=density, sample_scale=0.8)
    tmed = T.MediumConfig(combine=combine, density=density, sample_scale=0.8)
    jl = J.LightConfig(direction=direction, shadow_steps=32)
    tl = T.LightConfig(direction=direction, shadow_steps=32)

    def jfn(g):
        return jlight_volume(g, jl, J.RenderConfig(**kw), jmed,
                             scroll=None if scroll is None
                             else jnp.asarray(scroll))

    def tfn(g):
        return T.light_transmittance_volume(g, tl, T.RenderConfig(**kw),
                                            tmed, scroll=scroll)
    return jfn, tfn


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_light_volume_matches_jax(direction):
    grid = np.random.default_rng(1).uniform(0.0, 1.0, SHAPE) \
        .astype(np.float32)
    jfn, tfn = _both_lights(grid, direction, "single")
    got = tfn(torch.from_numpy(grid))
    want = np.asarray(jfn(jnp.asarray(grid)))
    assert tuple(got.shape) == want.shape == SHAPE
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the lit face is exactly 1.0, and the volume darkens away from it
    assert float(got.max()) == 1.0 and float(got.min()) < 0.5


def test_light_volume_box_and_4d_single():
    """A box that is not a cube (the axis choice divides by its range) and
    a 4-D grid with combine="single" (channel 0)."""
    grid = np.random.default_rng(2).uniform(0.0, 1.0, SHAPE + (2,)) \
        .astype(np.float32)
    box = ((-1.0, -0.5, -1.0), (1.0, 0.7, 2.0))
    jfn, tfn = _both_lights(grid, (0.5, 0.45, 0.6), "single", box=box)
    np.testing.assert_allclose(tfn(torch.from_numpy(grid)).numpy(),
                               np.asarray(jfn(jnp.asarray(grid))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("direction", [DIRECTIONS[0], DIRECTIONS[3]])
@pytest.mark.parametrize("scrolled", [False, True])
def test_light_volume_reference_matches_jax(direction, scrolled):
    grid = np.random.default_rng(3).uniform(0.1, 1.0, SHAPE + (4,)) \
        .astype(np.float32)
    scroll = _scroll() if scrolled else None
    jfn, tfn = _both_lights(grid, direction, "reference", scroll)
    got = tfn(torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(grid))),
                               rtol=1e-5, atol=1e-6)
    assert got.shape == SHAPE and got.min() < 0.9


@pytest.mark.parametrize("direction,combine", [
    (DIRECTIONS[0], "single"), (DIRECTIONS[1], "single"),
    (DIRECTIONS[2], "single"), (DIRECTIONS[5], "single"),
    (DIRECTIONS[0], "reference"), (DIRECTIONS[3], "reference")])
def test_light_volume_grid_gradient_matches_jax(direction, combine):
    """d/dgrid of a seeded weighted sum of L: back through every
    transposed shear step (and, for the reference medium, through
    materialize_sigma)."""
    shape = SHAPE if combine == "single" else SHAPE + (4,)
    grid = np.random.default_rng(4).uniform(0.1, 1.0, shape) \
        .astype(np.float32)
    w = np.random.default_rng(6).normal(size=SHAPE).astype(np.float32)
    scroll = None if combine == "single" else _scroll()
    jfn, tfn = _both_lights(grid, direction, combine, scroll)
    g = torch.from_numpy(grid.copy()).requires_grad_()
    (tfn(g) * torch.from_numpy(w)).sum().backward()
    want = np.asarray(jax.grad(
        lambda x: jnp.sum(jfn(x) * jnp.asarray(w)))(jnp.asarray(grid)))
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(g.grad.numpy(), want, rtol=2e-4,
                               atol=2e-4 * scale)


def test_light_volume_homogeneous_axial():
    """tests/test_lighting.py's closed form: constant density, light
    straight up (+z): tau at layer s is sigma * dl * (#layers above)."""
    S, c = 16, 0.4
    medium = T.MediumConfig(combine="single", density=2.0, sample_scale=0.5)
    light = T.LightConfig(direction=(0.0, 0.0, 1.0), shadow_steps=1)
    L = T.light_transmittance_volume(torch.full((S, S, S), c), light,
                                     T.RenderConfig(), medium).numpy()
    dl = (1.0 / S) * 2.0  # one slice step, box extent 2 along z
    for s in range(S):
        want = np.exp(-medium.density * c * medium.sample_scale * dl
                      * (S - 1 - s))
        np.testing.assert_allclose(L[s], want, rtol=1e-5)


def test_light_volume_rejects_unknown_combine():
    with pytest.raises(ValueError, match="unknown combine"):
        T.light_transmittance_volume(
            torch.zeros((4, 4, 4)), T.LightConfig(), T.RenderConfig(),
            T.MediumConfig(combine="other"))


@pytest.mark.parametrize("scrolled", [False, True])
@pytest.mark.parametrize("mode", ["mirror", "wrap"])
def test_materialize_sigma_matches_jax(scrolled, mode):
    grid = np.random.default_rng(7).uniform(0.0, 1.0, SHAPE + (4,)) \
        .astype(np.float32)
    scroll = _scroll() if scrolled else None
    jmed, tmed = J.MediumConfig(sample_scale=0.7), \
        T.MediumConfig(sample_scale=0.7)
    w = np.random.default_rng(8).normal(size=SHAPE).astype(np.float32)
    g = torch.from_numpy(grid.copy()).requires_grad_()
    got = T.materialize_sigma(g, tmed, scroll, mode)
    (got * torch.from_numpy(w)).sum().backward()

    def jfn(x):
        return jmaterialize_sigma(
            x, jmed, None if scroll is None else jnp.asarray(scroll), mode)
    want = np.asarray(jfn(jnp.asarray(grid)))
    assert tuple(got.shape) == want.shape == SHAPE
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    gwant = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x) * jnp.asarray(w)))(
        jnp.asarray(grid)))
    scale = float(np.abs(gwant).max())
    np.testing.assert_allclose(g.grad.numpy(), gwant, rtol=2e-4,
                               atol=2e-4 * scale)
    for ch in range(4):
        assert float(g.grad[..., ch].abs().max()) > 0.0


def test_materialize_sigma_needs_four_channels():
    with pytest.raises(ValueError, match="4"):
        T.materialize_sigma(torch.zeros((4, 4, 4)), T.MediumConfig())
    with pytest.raises(ValueError, match="4"):
        T.materialize_sigma(torch.zeros((4, 4, 4, 3)), T.MediumConfig())


def test_clip_unit_gradient_matches_jnp_clip():
    """jnp.clip is minimum(maximum(x, 0), 1): gradient 1 inside, 0.5 at a
    tie with a bound, 0 outside. torch.clamp would pass 1 at the bounds."""
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    want_grad = np.asarray(jax.vmap(jax.grad(
        lambda v: jnp.clip(v, 0.0, 1.0)))(jnp.asarray(x)))
    np.testing.assert_array_equal(want_grad, [0.0, 0.5, 1.0, 0.5, 0.0])
    t = torch.from_numpy(x.copy()).requires_grad_()
    y = clip_unit(t)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jnp.clip(jnp.asarray(x), 0.0, 1.0)))
    ct = torch.tensor([2.0, 3.0, 4.0, 5.0, 6.0])
    (y * ct).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want_grad * ct.numpy())
    np.testing.assert_array_equal(clip_unit_grad(torch.from_numpy(x)).numpy(),
                                  want_grad)
