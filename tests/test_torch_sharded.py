"""The port's parallel/ (sweep_sharded, render_sharded, mesh) on gloo ranks
spawned on the CPU (tests/test_torch_sharded_ranks.py, once per world size
for this module), against the JAX package's parallel/ on the conftest's
8-device CPU mesh at the same (data, slab) shape and against the port's
unsharded render.

Tolerances are tests/test_sweep_sharded.py's: images rtol = atol = 2e-4,
gradients rtol=1e-3, atol=1e-3 * max|grad| (the slab composite sums in
another order than one sweep; the gathers' backward sums the ranks'
cotangents); the early-stop gate within 20 eps of the unsharded frame."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
import volumetricrenderer_tpu_torch as T
from test_sweep import smooth_volume
from test_torch_sharded_ranks import plan_arrays, run_world, torch_plan
from volumetricrenderer_tpu.ops.lighting import light_transmittance_volume
from volumetricrenderer_tpu.ops.sweep import plan_sweep, sweep_render
from volumetricrenderer_tpu.parallel.mesh import make_mesh
from volumetricrenderer_tpu.parallel.sweep_sharded import (
    make_sweep_train_step, sweep_render_sharded)
from volumetricrenderer_tpu_torch.ops.sweep import sweep_render as tsweep

torch.set_num_threads(1)

IMG_TOL, GRAD_TOL, EPS = 2e-4, 1e-3, 1e-3
EYES = {"x-": (2.6, 2.1, 2.9), "z+": (0.4, 0.3, -3.0),
        "x+": (-3.0, 0.4, 0.3)}
LIGHT = dict(direction=(0.3, 0.2, 1.0), ambient=0.2, shadow_steps=16)


def _cfgs(gate=-1.0, mode="mirror"):
    kw = dict(emission=True, quadrature="sliced",
              early_stop_transmittance=gate, address_mode=mode)
    return J.RenderConfig(**kw), T.RenderConfig(**kw)


def _plan(grid_shape, eye="x-", n_slices=None, height=32, jcfg=None):
    cam = J.make_camera(J.CameraConfig(eye=EYES[eye], width=64,
                                       height=height))
    return plan_sweep(cam, grid_shape, jcfg or _cfgs()[0], n_slices=n_slices)


def _single(density=6.0):
    return (J.MediumConfig(combine="single", density=density),
            T.MediumConfig(combine="single", density=density))


def _grid4():
    return np.random.default_rng(3).uniform(0.2, 0.8, (16, 16, 16, 4)) \
        .astype(np.float32)


def _scroll():
    return np.random.default_rng(5).uniform(-1.5, 1.5, (4, 3)) \
        .astype(np.float32)


def _jmesh(shape):
    return make_mesh(data=shape[0], slab=shape[1],
                     devices=jax.devices()[:shape[0] * shape[1]])


@dataclasses.dataclass
class Scene:
    """One frame's inputs for both packages."""
    grid: np.ndarray
    jplan: object
    jcfg: object
    tcfg: object
    jmed: object
    tmed: object
    light: tuple = (None, None)
    scroll: object = None
    lvol: object = None

    def job(self, shape, grad=True):
        return ("frame", dict(shape=shape, grid=self.grid,
                              plan=plan_arrays(self.jplan), cfg=self.tcfg,
                              medium=self.tmed, light=self.light[1],
                              scroll=self.scroll, lvol=self.lvol, grad=grad))

    def jax_frame(self, shape=None):
        kw = dict(scroll=None if self.scroll is None
                  else jnp.asarray(self.scroll),
                  light_volume=None if self.lvol is None
                  else jnp.asarray(self.lvol))
        if shape is None:
            return np.asarray(sweep_render(jnp.asarray(self.grid), self.jplan,
                                           self.jcfg, self.jmed,
                                           self.light[0], **kw))
        return np.asarray(sweep_render_sharded(
            jnp.asarray(self.grid), self.jplan, _jmesh(shape), self.jcfg,
            self.jmed, self.light[0], **kw))

    def port(self):
        """The port's unsharded frame and gradients of sum(rgb^2)."""
        g = torch.from_numpy(self.grid.copy()).requires_grad_()
        lv = None if self.lvol is None else \
            torch.from_numpy(self.lvol.copy()).requires_grad_()
        img = tsweep(g, torch_plan(plan_arrays(self.jplan)), self.tcfg,
                     self.tmed, self.light[1],
                     scroll=None if self.scroll is None
                     else torch.from_numpy(self.scroll), light_volume=lv)
        (img[..., :3] ** 2).sum().backward()
        return (img.detach().numpy(), g.grad.numpy(),
                None if lv is None else lv.grad.numpy())


def _base(eye="x-", size=16, **kw):
    grid = np.asarray(smooth_volume(size))
    jcfg, tcfg = _cfgs()
    jmed, tmed = _single()
    return Scene(grid, _plan(grid.shape, eye, **kw), jcfg, tcfg, jmed, tmed)


def _reference(mode="mirror"):
    jcfg, tcfg = _cfgs(mode=mode)
    grid = _grid4()
    return Scene(grid, _plan(grid.shape[:3], "x-"), jcfg, tcfg,
                 J.MediumConfig(density=4.0), T.MediumConfig(density=4.0),
                 scroll=_scroll())


def _shadowed():
    s = _base()
    jl, tl = J.LightConfig(**LIGHT), T.LightConfig(**LIGHT)
    s.light = (jl, tl)
    s.lvol = np.asarray(light_transmittance_volume(jnp.asarray(s.grid), jl,
                                                   s.jcfg, s.jmed))
    return s


def _gated():
    s = _base()
    s.jcfg, s.tcfg = _cfgs(gate=EPS)
    s.jmed, s.tmed = _single(density=50.0)
    return s


SCENES = {
    "base": _base,
    "z+": lambda: _base("z+"),
    "x+": lambda: _base("x+"),
    "subvoxel": lambda: _base(n_slices=8),
    "size12": lambda: _base(size=12),
    "odd-rows": lambda: _base(height=33),
    "reference": _reference,
    "reference-clamp": lambda: _reference("clamp"),
    "shadowed": _shadowed,
    "gated": _gated,
}
# (scene, mesh shape) -> the world that runs it
FRAMES = {
    2: [("base", (1, 2)), ("base", (2, 1)), ("x+", (1, 2)),
        ("reference-clamp", (1, 2))],
    3: [("size12", (1, 3))],
    4: [("base", (2, 2)), ("base", (1, 4)), ("z+", (2, 2)),
        ("subvoxel", (2, 2)), ("odd-rows", (2, 2)), ("reference", (2, 2)),
        ("shadowed", (2, 2)), ("gated", (2, 2))],
}
TRAIN_STEPS, TRAIN_LR = 12, 5e-2


@pytest.fixture(scope="module")
def scenes():
    return {name: make() for name, make in SCENES.items()}


def _train_job(scene, shape, light=None, steps=TRAIN_STEPS):
    target = scene.port()[0][..., :3]
    return ("train", dict(shape=shape, plan=plan_arrays(scene.jplan),
                          cfg=scene.tcfg, medium=scene.tmed, target=target,
                          light=light, steps=steps, lr=TRAIN_LR))


def _rays_setup():
    cam = T.make_camera(T.CameraConfig(width=32, height=31))
    o, d = (t.numpy() for t in T.camera_rays(cam))
    grid = np.random.default_rng(2).uniform(size=(8, 8, 8)) \
        .astype(np.float32)
    kw = dict(max_steps=16, step_size=4.0 / 16.0, emission=True,
              early_stop_transmittance=0.0)
    return (o, d, grid, J.RenderConfig(**kw), T.RenderConfig(**kw),
            J.MediumConfig(combine="single", density=4.0),
            T.MediumConfig(combine="single", density=4.0))


def _rays_job(shape, spatial, steps=0):
    o, d, grid, _, tcfg, _, tmed = _rays_setup()
    target = None
    if steps:
        from volumetricrenderer_tpu_torch.ops.integrate import render_rays
        target = render_rays(torch.from_numpy(grid), torch.from_numpy(o),
                             torch.from_numpy(d), tcfg, tmed,
                             T.LightConfig())[..., :3].numpy()
    return ("rays", dict(shape=shape, grid=grid, origins=o, directions=d,
                         cfg=tcfg, medium=tmed, light=T.LightConfig(),
                         spatial=spatial, target=target, steps=steps))


@pytest.fixture(scope="module")
def worlds(scenes, tmp_path_factory):
    """Every job, one spawn per world size."""
    jobs = {w: {f"{n} {s}": scenes[n].job(s) for n, s in cases}
            for w, cases in FRAMES.items()}
    jobs[4]["train (2, 2)"] = _train_job(scenes["base"], (2, 2))
    jobs[2]["train shadowed (1, 2)"] = _train_job(
        scenes["shadowed"], (1, 2), T.LightConfig(**LIGHT), steps=8)
    jobs[4]["train shadowed (2, 2)"] = _train_job(
        scenes["shadowed"], (2, 2), T.LightConfig(**LIGHT), steps=8)
    jobs[2]["rays (2, 1)"] = _rays_job((2, 1), False, steps=15)
    jobs[4]["rays spatial (2, 2)"] = _rays_job((2, 2), True, steps=15)
    jobs[3]["bootstrap"] = ("bootstrap", {})
    tmp = tmp_path_factory.mktemp("ranks")
    out = {}
    for w, js in jobs.items():
        out.update(run_world(w, js, tmp))
    return out


def _close_grad(got, want):
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                               atol=GRAD_TOL * scale)


@pytest.mark.parametrize("scene,shape", [c for w in sorted(FRAMES)
                                         for c in FRAMES[w]
                                         if c[0] != "gated"])
def test_sharded_frame_matches_jax_and_unsharded(worlds, scenes, scene,
                                                 shape):
    """The frame against the JAX sweep_render_sharded at the same mesh
    shape (base scenes; the JAX frame otherwise) and against the port's
    unsharded sweep_render; the grid's (and the light volume's) gradient of
    sum(rgb^2) against the unsharded port's, and at (2, 2) against the JAX
    sharded gradient. Ranks that hold the same rows return the same frame,
    and the data ranks of one slab the same gradient."""
    s = scenes[scene]
    got = worlds[f"{scene} {shape}"]
    # the JAX sharded path at every mesh shape of the base scenes, else its
    # unsharded frame (which its own tests hold the sharded one to; rows
    # that do not divide over "data" its row sharding refuses)
    want = s.jax_frame(shape if scene in ("base", "size12") else None)
    np.testing.assert_allclose(got["image"], want, rtol=IMG_TOL,
                               atol=IMG_TOL)
    img, grad, lgrad = s.port()
    np.testing.assert_allclose(got["image"], img, rtol=IMG_TOL, atol=IMG_TOL)
    assert float(got["image"][..., 3].max()) > 0.0
    _close_grad(got["grad"], grad)
    assert got["spread"] < 1e-5
    if lgrad is not None:
        _close_grad(got["light_grad"], lgrad)
    if scene in ("base", "reference", "shadowed") and shape == (2, 2):
        def loss(g, lv):
            return jnp.sum(sweep_render_sharded(
                g, s.jplan, _jmesh(shape), s.jcfg, s.jmed, s.light[0],
                scroll=None if s.scroll is None else jnp.asarray(s.scroll),
                light_volume=lv)[..., :3] ** 2)
        jgrad = jax.jit(jax.grad(loss, argnums=(0, 1) if s.lvol is not None
                                 else 0))(
            jnp.asarray(s.grid),
            None if s.lvol is None else jnp.asarray(s.lvol))
        if s.lvol is not None:
            jgrad, jlgrad = jgrad
            _close_grad(got["light_grad"], np.asarray(jlgrad))
        _close_grad(got["grad"], np.asarray(jgrad))


def test_sharded_rows_that_do_not_divide_return_the_whole_frame(worlds):
    """33 pixel rows over 2 data ranks: every rank warps the whole frame
    (the JAX package's full-image path), held by all four ranks."""
    got = worlds["odd-rows (2, 2)"]
    assert got["image"].shape == (33, 64, 4) and got["holders"] == 4
    assert worlds["base (2, 2)"]["holders"] == 2


def test_sharded_early_exit_gate(worlds, scenes):
    """The slab-local early-stop gate: within 20 eps of the gated
    unsharded frame (JAX's and the port's), and the gate is active."""
    s = scenes["gated"]
    got = worlds["gated (2, 2)"]["image"]
    want = s.jax_frame()
    assert np.abs(got - want).max() < 20 * EPS
    assert np.abs(got - s.port()[0]).max() < 20 * EPS
    ungated = dataclasses.replace(s, jcfg=_cfgs()[0]).jax_frame()
    assert np.abs(ungated - want).max() > 0


def _jax_train(s, shape, light=None, steps=2):
    """The JAX make_sweep_train_step on the same mesh shape from the same
    constant grid: its first `steps` losses, and the gradient of its loss
    at the first step (jax.grad of the same function)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = _jmesh(shape)
    step, opt = make_sweep_train_step(mesh, s.jplan, s.jcfg, s.jmed,
                                      light=light, learning_rate=TRAIN_LR)
    target = jax.device_put(jnp.asarray(s.port()[0][..., :3]),
                            NamedSharding(mesh, P("data")))

    def loss(g):
        lv = None if light is None else light_transmittance_volume(
            g, light, s.jcfg, s.jmed)
        img = sweep_render_sharded(g, s.jplan, mesh, s.jcfg, s.jmed, light,
                                   light_volume=lv)
        return jnp.mean((img[..., :3] - target) ** 2)

    def g0():
        return jax.device_put(jnp.full(s.grid.shape, 0.4, jnp.float32),
                              NamedSharding(mesh, P("slab")))
    grad = np.asarray(jax.jit(jax.grad(loss))(g0()))
    g = g0()
    state, losses = opt.init(g), []
    for _ in range(steps):
        g, state, value = step(g, state, target)
        losses.append(float(value))
    return np.array(losses), grad


def _check_train(got, s, shape, light=None, falls_to=0.5):
    """The port's sharded step against the JAX step: the first step's grid
    gradient (which fixes the loss's scale and the weight of every path
    into it; Adam's update alone would not) at the gradient tolerance, the
    first two losses (the second after one Adam update and clamp) at the
    image tolerance; then the loss falls below `falls_to` of the first,
    the grid stays in [0, 1], and the data ranks hold the same gradient
    and grid."""
    losses = got["losses"]
    want_losses, want_grad = _jax_train(s, shape, light)
    _close_grad(got["grad1"], want_grad)
    np.testing.assert_allclose(losses[:2], want_losses, rtol=IMG_TOL)
    assert losses[-1] < falls_to * losses[0], losses
    assert got["spread"] == 0.0 and got["grad_spread"] == 0.0
    assert got["grid"].min() >= 0.0 and got["grid"].max() <= 1.0


def test_sharded_train_step_optimizes(worlds, scenes):
    """make_sweep_train_step on a (2, 2) mesh against the JAX step: the
    first gradient and the first two losses; the loss falls below 0.3 of
    the first."""
    _check_train(worlds["train (2, 2)"], scenes["base"], (2, 2),
                 falls_to=0.3)


def test_sharded_shadowed_train_step_optimizes(worlds, scenes):
    """The shadowed step on a (1, 2) mesh (the light volume rebuilt from
    the gathered grid every step, its gradient through the light sweep)
    against the JAX step; the loss falls below half the first."""
    _check_train(worlds["train shadowed (1, 2)"], scenes["shadowed"],
                 (1, 2), J.LightConfig(**LIGHT))


def test_sharded_shadowed_train_step_across_data_ranks(worlds, scenes):
    """The shadowed step on a (2, 2) mesh: the light path's gradient
    gathered over the slabs and summed over the data ranks, against the
    JAX step as above."""
    _check_train(worlds["train shadowed (2, 2)"], scenes["shadowed"],
                 (2, 2), J.LightConfig(**LIGHT))


@pytest.mark.parametrize("name,shape,spatial", [
    ("rays (2, 1)", (2, 1), False), ("rays spatial (2, 2)", (2, 2), True)])
def test_render_sharded_matches_jax(worlds, name, shape, spatial):
    """render_sharded's renderer (31 rows over 2 data ranks, padded to 32)
    against the JAX renderer at the same mesh shape and render_rays; its
    train step's first loss equals the JAX step's, and the loss halves in
    15 steps."""
    from volumetricrenderer_tpu.ops.integrate import render_rays
    from volumetricrenderer_tpu.parallel.render_sharded import (
        make_sharded_renderer, make_train_step, shard_rays)
    o, d, grid, jcfg, _, jmed, _ = _rays_setup()
    got = worlds[name]
    mesh = _jmesh(shape)
    so, sd, pad = shard_rays(jnp.asarray(o), jnp.asarray(d), mesh)
    fn = make_sharded_renderer(mesh, jcfg, jmed, J.LightConfig(),
                               spatial_grid=spatial)
    want = np.asarray(fn(jnp.asarray(grid), so, sd,
                         jnp.zeros((1, 3), jnp.float32)))
    want = want[:want.shape[0] - pad]
    assert got["pad"] == pad
    np.testing.assert_allclose(got["image"], want, rtol=1e-4, atol=1e-5)
    direct = np.asarray(render_rays(jnp.asarray(grid), jnp.asarray(o),
                                    jnp.asarray(d), jcfg, jmed,
                                    J.LightConfig()))
    np.testing.assert_allclose(got["image"], direct, rtol=1e-4, atol=1e-5)
    losses = got["losses"]
    assert losses[-1] < 0.5 * losses[0], losses
    assert np.all(np.isfinite(got["grid"]))
    step, opt = make_train_step(mesh, jcfg, jmed, J.LightConfig(),
                                spatial_grid=spatial)
    target = render_rays(jnp.asarray(grid), jnp.asarray(o), jnp.asarray(d),
                         jcfg, jmed, J.LightConfig())[..., :3]
    target = jnp.pad(target, ((0, pad), (0, 0), (0, 0)))
    g0 = jnp.full(grid.shape, 0.2, jnp.float32)
    _, _, loss0 = step(g0, opt.init(g0), so, sd, target)
    np.testing.assert_allclose(losses[0], float(loss0), rtol=IMG_TOL)


def test_process_summary_in_a_group(worlds):
    s = worlds["bootstrap"]
    assert s["process_index"] == 0 and s["process_count"] == 3
    assert s["global_devices"] == 3 and s["backend"] == "gloo"


@pytest.mark.parametrize("combine", ["single", "reference"])
@pytest.mark.parametrize("eye,n_slab,n_data", [
    ("x-", 2, 1), ("x-", 4, 2), ("z+", 2, 2), ("x+", 3, 1)])
def test_split_sweep_in_one_process_equals_the_unsharded_sweep(
        combine, eye, n_slab, n_data):
    """split_sweep, the per-rank body on every (slab, data) block in one
    process (what chip_smoke.py runs through K1/K2 and K4/K5 on the card),
    composited front to back, against the unsharded plain sweep: maps at
    2e-4 with the gate off, the gradient of seeded cotangents at 1e-3."""
    from volumetricrenderer_tpu_torch.kernels import sweep_fwd, sweep_ref_fwd
    from volumetricrenderer_tpu_torch.parallel.sweep_sharded import \
        split_sweep
    size = 12 if n_slab == 3 else 16
    rng = np.random.default_rng(4)
    if combine == "single":
        grid = np.asarray(smooth_volume(size))
        tmed, scroll = _single()[1], None
    else:
        grid = rng.uniform(0.2, 0.8, (size,) * 3 + (4,)).astype(np.float32)
        tmed, scroll = T.MediumConfig(density=4.0), \
            torch.from_numpy(_scroll())
    jplan = _plan(grid.shape[:3], eye)
    tplan, tcfg = torch_plan(plan_arrays(jplan)), _cfgs()[1]
    cts = [torch.from_numpy(rng.normal(size=tplan.base_shape)
                            .astype(np.float32)) for _ in range(3)]

    def run(split):
        g = torch.from_numpy(grid.copy()).requires_grad_()
        if split:
            maps = split_sweep(g, tplan, tcfg, tmed, n_slab, n_data, scroll)
        elif combine == "single":
            maps = sweep_fwd.sweep_base(g.permute(tplan.perm), tplan, tcfg,
                                        tmed)
        else:
            maps = sweep_ref_fwd.sweep_base_ref(
                g.permute(tplan.perm + (3,)), tplan, tcfg, tmed,
                scroll=scroll)
        sum((m * c).sum() for m, c in zip(maps[:3], cts)).backward()
        return [m.detach() for m in maps], g.grad

    (got, dg), (want, dg_want) = run(True), run(False)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=IMG_TOL, atol=IMG_TOL)
    _close_grad(dg.numpy(), dg_want.numpy())
