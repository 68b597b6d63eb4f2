"""The sharded path's runners (volumetricrenderer_tpu_torch/tools/:
multichip, sharded_step, scaling_rehearsal) on gloo ranks on the CPU
through their own launcher (tools.spawn_ranks), once per world size for
the whole module (tests/test_torch_sharded_ranks.runner_jobs runs each
world's jobs: world 1 in this process, as under torchrun, worlds 2 and 4
spawned from a thread while the JAX side compiles), and the stage
profiler profile_parts in this process, against the JAX package's
functions on the conftest's 8-device CPU mesh at the same mesh shape. The
JAX side is composed as each JAX entry point composes it (__graft_entry__.
dryrun_multichip, tools/sharded_tpu.py, tools/scaling_rehearsal.py,
tools/profile_parts.py); none of them runs (the tools write their
artifacts into the working directory).

Tolerances are tests/test_torch_sharded.py's: losses rtol 2e-4
(test_sharded_train_step_optimizes), frames 2e-4
(tests/test_sweep_sharded.py), and bit for bit at one rank; the stages'
those named in test_profile_parts_stages_match_jax.

* multichip at 2 ranks (mesh (1, 2)) and 4 (mesh (2, 2)): the loss of
  the shadowed step against the JAX dryrun_multichip body;
* sharded_step at 1 and 2 ranks, 16^3 at 32x32: the sharded frame against
  the unsharded one (0.0 at one rank), the first two train losses against
  the JAX make_sweep_train_step's, the 512 phase run at 32^3 and 8 slices
  (and left out by VOLT_SH_512=0);
* scaling_rehearsal at shapes (2, 1) and (1, 2), 16^3 at 32x32: each
  shape's three losses (the last its final loss) against the JAX step's
  on the same mesh shape;
* profile_parts at 16^3 and 32x32: each stage's value and gradient
  against the JAX stage's; its main() on the CPU.
"""
import concurrent.futures
import contextlib
import functools
import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import volumetricrenderer_tpu as J
from test_torch_sharded_ranks import plan_arrays, runner_jobs, torch_plan
from volumetricrenderer_tpu.models.scene import cloud_volume
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.lighting import light_transmittance_volume
from volumetricrenderer_tpu.ops.sweep import (_sweep_base, finish_image,
                                              plan_sweep, sweep_render)
from volumetricrenderer_tpu.parallel.mesh import make_mesh
from volumetricrenderer_tpu.parallel.sweep_sharded import (
    make_sweep_train_step, sweep_render_sharded)
import volumetricrenderer_tpu_torch as T
from volumetricrenderer_tpu_torch.tools import (multichip, profile_parts,
                                                scaling_rehearsal,
                                                sharded_step, spawn_ranks)

torch.set_num_threads(1)

RTOL = 2e-4
NO_LAUNCH = {"sweep_fwd": 0, "sweep_bwd": 0, "sweep_ref_fwd": 0,
             "sweep_ref_bwd": 0}
# sharded_step's and scaling_rehearsal's sizes: one scene, so the JAX
# steps of a mesh shape serve both
VOLUME, IMAGE = 16, 32
SH = {"volume": VOLUME, "width": IMAGE, "height": IMAGE, "iters": 1,
      "do512": True, "volume_512": 32, "slices_512": 8}
SR = {"volume": VOLUME, "image": IMAGE, "steps": 2,
      "shapes": [(2, 1), (1, 2)]}
JOBS = {
    1: {"sharded_step": ("sharded_step", "rank_body", (SH,))},
    2: {"multichip": ("multichip", "dryrun", ()),
        "sharded_step": ("sharded_step", "rank_body", (SH,)),
        "scaling": ("scaling_rehearsal", "rank_body", (SR,))},
    4: {"multichip": ("multichip", "dryrun", ())},
}


@contextlib.contextmanager
def _env(**names):
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(names)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def _spawned():
    with _env(OMP_NUM_THREADS="1"):
        return {w: spawn_ranks(runner_jobs, w, "cpu", JOBS[w])
                for w in (2, 4)}


@pytest.fixture(scope="module")
def worlds():
    """world size -> its results. World 1 runs in this process, as under
    torchrun (RANK, WORLD_SIZE, LOCAL_RANK and a localhost store set: the
    launcher runs in place); worlds 2 and 4 are spawned, one thread per
    rank, from a thread while the tests compute the JAX side."""
    with _env(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
              MASTER_ADDR="localhost", MASTER_PORT=_free_port()):
        one = spawn_ranks(runner_jobs, 1, "cpu", JOBS[1])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(_spawned)
        yield lambda w: one if w == 1 else spawned.result()[w]


def _jmesh(data, slab):
    return make_mesh(data=data, slab=slab,
                     devices=jax.devices()[:data * slab])


@functools.lru_cache(maxsize=None)
def jax_cloud(size):
    return jax.jit(cloud_volume, static_argnums=(0, 1))(size, 7)


@functools.lru_cache(maxsize=None)
def jax_dryrun(n):
    """The body of __graft_entry__.dryrun_multichip(n), its loss; the
    cloud, the light volume and the target frame jitted, as the JAX
    tools jit them."""
    slab = 2 if n % 2 == 0 else 1
    mesh = _jmesh(n // slab, slab)
    cfg = J.RenderConfig(emission=True, quadrature="sliced",
                         early_stop_transmittance=-1.0)
    medium = J.MediumConfig(combine="single", density=4.0)
    light = J.LightConfig(direction=(0.3, 0.2, 1.0), ambient=0.2,
                          shadow_steps=8)
    size = 8 * slab
    grid = jax_cloud(size)
    cam = make_camera(J.CameraConfig(width=32, height=16))
    plan = plan_sweep(cam, grid.shape, cfg, n_slices=max(size // 2, slab))
    lv = jax.jit(lambda g: light_transmittance_volume(g, light, cfg,
                                                      medium))(grid)
    target = jax.jit(lambda g, lv: sweep_render_sharded(
        g, plan, mesh, cfg, medium, light, light_volume=lv)[..., :3])(grid,
                                                                      lv)
    target = jax.device_put(target, NamedSharding(mesh, P("data")))
    step, optimizer = make_sweep_train_step(mesh, plan, cfg, medium,
                                            light=light)
    g0 = jax.device_put(jnp.full_like(grid, 0.4),
                        NamedSharding(mesh, P("slab")))
    _, _, loss = step(g0, optimizer.init(g0), target)
    return float(loss)


@functools.lru_cache(maxsize=None)
def jax_scene():
    """(grid, plan, cfg, medium) of sharded_step's, scaling_rehearsal's
    and profile_parts's tests: cloud_volume(16, 7), the default camera at
    32x32, emission, density 8."""
    cfg = J.RenderConfig(emission=True, quadrature="sliced")
    medium = J.MediumConfig(combine="single", density=8.0)
    cam = make_camera(J.CameraConfig(width=IMAGE, height=IMAGE))
    grid = jax_cloud(VOLUME)
    return grid, plan_sweep(cam, grid.shape, cfg), cfg, medium


@functools.lru_cache(maxsize=None)
def jax_frame():
    """The unsharded frame of jax_scene, the train steps' target."""
    grid, plan, cfg, medium = jax_scene()
    return jax.jit(lambda g: sweep_render(g, plan, cfg, medium))(grid)


@functools.lru_cache(maxsize=None)
def jax_losses(data, slab, steps=3):
    """The first `steps` losses of the JAX make_sweep_train_step on a
    (data, slab) mesh (lr 5e-2 from a grid of 0.4, the target the unsharded
    frame), as tools/sharded_tpu.py and tools/scaling_rehearsal.py run
    it."""
    grid, plan, cfg, medium = jax_scene()
    mesh = _jmesh(data, slab)
    target = jax.device_put(jax_frame()[..., :3],
                            NamedSharding(mesh, P("data")))
    step, optimizer = make_sweep_train_step(mesh, plan, cfg, medium,
                                            learning_rate=5e-2)
    g = jax.device_put(jnp.full_like(grid, 0.4),
                       NamedSharding(mesh, P("slab")))
    state, losses = optimizer.init(g), []
    for _ in range(steps):
        g, state, loss = step(g, state, target)
        losses.append(float(loss))
    return tuple(losses)


@pytest.mark.parametrize("n,mesh", [(2, [1, 2]), (4, [2, 2])])
def test_multichip_loss_matches_jax_dryrun(worlds, n, mesh):
    """The shadowed sharded step on n gloo ranks against the JAX
    dryrun_multichip(n) body: the same mesh, a finite loss within rtol
    2e-4; no kernel launch and no general sweep on the CPU."""
    want = jax_dryrun(n)
    line = worlds(n)["multichip"]
    assert (line["n_devices"], line["mesh"], line["ok"]) == (n, mesh, True)
    assert line["launches_per_rank"] == [NO_LAUNCH] * n
    assert line["general_sweep_calls"] == 0
    assert np.isfinite(line["loss"])
    np.testing.assert_allclose(line["loss"], want, rtol=RTOL)


@pytest.mark.parametrize("ranks", [1, 2])
def test_sharded_step_frames_and_losses(worlds, ranks):
    """sharded_step on a (1, ranks) mesh: the sharded frame equal to the
    unsharded one bit for bit at one rank and within 2e-4 at two, the six
    variants timed, the train loss falling, its first two losses against
    the JAX step's on a (1, 2) mesh (the JAX step's loss does not depend on
    the mesh: tests/test_sweep_sharded.py holds it so; scaling_rehearsal's
    test reads the same JAX run), and the 512 phase at 32^3 and 8
    slices."""
    want = jax_losses(1, 2)[:2]
    line = worlds(ranks)["sharded_step"]
    assert line["ranks"] == ranks and line["mesh"] == f"data=1 x slab={ranks}"
    if ranks == 1:
        assert line["fwd_max_abs_diff"] == 0.0
    assert line["fwd_max_abs_diff"] < RTOL
    assert set(line["ms_per_frame"]) == set(sharded_step.VARIANTS)
    for stage in ("base_fwd", "full_fwd", "full_fwdbwd"):
        assert line[f"{stage}_sharded_vs_unsharded"] > 0.0
    losses = line["train_step_losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses[:2], want, rtol=RTOL)
    assert line["sharded_512_128slices_fwdbwd_ms"] > 0.0
    assert line["launches"] == NO_LAUNCH
    assert line["general_sweep_calls"] == 0


def test_sharded_step_512_phase_is_cut_by_its_variable(monkeypatch):
    monkeypatch.setenv("VOLT_SH_512", "0")
    assert sharded_step.settings()["do512"] is False
    monkeypatch.setenv("VOLT_SH_512", "1")
    assert sharded_step.settings()["do512"] is True


@pytest.mark.parametrize("k,shape", [(0, (2, 1)), (1, (1, 2))])
def test_scaling_rehearsal_final_loss_matches_jax(worlds, k, shape):
    """Each mesh shape's final loss (after the first step and STEPS = 2
    timed ones) against the JAX step's third loss on the same shape."""
    want = jax_losses(*shape)
    row = worlds(2)["scaling"]["shapes"][k]
    assert row["mesh"] == {"data": shape[0], "slab": shape[1]}
    assert row["launches"] == NO_LAUNCH
    assert len(row["losses"]) == 3 and row["final_loss"] == row["losses"][-1]
    np.testing.assert_allclose(row["losses"], want, rtol=RTOL)


def test_scaling_rehearsal_shapes_parse():
    assert scaling_rehearsal.shapes(scaling_rehearsal.SHAPES) == [
        (8, 1), (4, 2), (2, 4), (1, 8)]
    assert scaling_rehearsal.shapes("1X1, 2x2") == [(1, 1), (2, 2)]
    assert multichip.mesh_shape(8) == (4, 2)
    assert multichip.mesh_shape(3) == (3, 1)


def _close_grad(got, want, tol):
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_profile_parts_stages_match_jax():
    """Each stage of profile_parts on the JAX plan's arrays (16^3 at
    32x32) against the JAX tool's stage function: the base maps' sum (K1's
    plain version and the general sweep against the JAX jnp sweep
    _sweep_base, rtol 2e-4 as tests/test_torch_sweep_fwd.py) and its
    gradient (rtol 2e-4, atol 2e-4 * max, tests/test_torch_sweep_bwd.py);
    the frame's sum(rgb^2) and its grid gradient against sweep_render's
    (the same tolerances, JAX at "highest" matmul precision as
    tests/test_torch_tools.py); the warp's loss and its gradient to the
    base maps against finish_image's (1e-5 of the largest gradient,
    tests/test_torch_warp_vjp.py)."""
    jgrid, jplan, jcfg, jmed = jax_scene()
    tcfg = T.RenderConfig(emission=True, quadrature="sliced")
    tmed = T.MediumConfig(combine="single", density=8.0)
    fns = profile_parts.stages(torch.from_numpy(np.array(jgrid)),
                               torch_plan(plan_arrays(jplan)), tcfg, tmed)
    assert tuple(fns) == profile_parts.STAGES
    got = {name: fn() for name, fn in fns.items()}

    def base(gp):
        maps = _sweep_base(gp, None, jplan.slice_z, jplan.v_grid,
                           jplan.u_grid, jplan.seglen, jplan, jcfg, jmed,
                           None, None)
        return sum(jnp.sum(m) for m in maps)

    def full(g):
        return jnp.sum(sweep_render(g, jplan, jcfg, jmed)[..., :3] ** 2)

    def warp(maps):
        return jnp.sum(finish_image(maps, jplan, jcfg, jmed)[..., :3] ** 2)

    def wsum(gp):
        return jnp.sum(_sweep_base(gp, None, jplan.slice_z, jplan.v_grid,
                                   jplan.u_grid, jplan.seglen, jplan, jcfg,
                                   jmed, None, None)[2])

    _, maps = got["warp_fwdbwd"]
    gperm = jnp.transpose(jgrid, jplan.perm)
    with jax.default_matmul_precision("highest"):
        base_v, base_g = jax.jit(jax.value_and_grad(base))(gperm)
        wsum_g = jax.jit(jax.grad(wsum))(gperm)
        full_v, full_g = jax.jit(jax.value_and_grad(full))(jgrid)
        warp_v, warp_g = jax.jit(jax.value_and_grad(warp))(
            tuple(jnp.asarray(m.detach().numpy()) for m in maps))
    for name in ("base_fwd", "base_fwd_general", "base_fwdbwd"):
        value = got[name][0] if name.endswith("bwd") else got[name]
        np.testing.assert_allclose(float(value), float(base_v), rtol=RTOL)
    # In emission wsum = 1 - trans, and acc and hit carry no gradient: the
    # sum's gradient is zero but for rounding, held at the tolerance of
    # one map's gradient (wsum's).
    scale = float(np.abs(np.asarray(wsum_g)).max())
    assert scale > 0.0
    np.testing.assert_allclose(got["base_fwdbwd"][1].grad.numpy(),
                               np.asarray(base_g), rtol=RTOL,
                               atol=RTOL * scale)
    for name in ("full_fwd", "full_fwdbwd"):
        value = got[name][0] if name.endswith("bwd") else got[name]
        np.testing.assert_allclose(float(value), float(full_v), rtol=RTOL)
    _close_grad(got["full_fwdbwd"][1].grad.numpy(), np.asarray(full_g), RTOL)
    for name in ("warp_fwd", "warp_fwdbwd"):
        value = got[name][0] if name.endswith("bwd") else got[name]
        np.testing.assert_allclose(float(value), float(warp_v), rtol=1e-5)
    # the frame's rgb reads wsum alone: each map's gradient (none or zero
    # for the others) at the tolerance of the largest
    scale = max(float(np.abs(np.asarray(w)).max()) for w in warp_g)
    assert scale > 0.0
    for m, w in zip(maps, warp_g):
        got_g = np.zeros(m.shape, np.float32) if m.grad is None \
            else m.grad.numpy()
        np.testing.assert_allclose(got_g, np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * scale)


def test_profile_parts_main(monkeypatch, capsys, tmp_path):
    """main() on the CPU at 16^3 / 48x32: one line with every stage, the
    general sweep's calls counted (warm-ups and timed calls), no kernel
    launch, no file written."""
    for k, v in {"V": "16", "W": "48", "H": "32", "K": "1",
                 "I": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    assert profile_parts.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["ms_per_frame"]) == set(profile_parts.STAGES)
    assert line["timed_runs"] == 1 and line["launches"] == NO_LAUNCH
    assert line["general_sweep_calls"] == line["timed_runs"] + \
        line["warmup_runs"]
    assert (line["device"], line["power_limit_w"]) == ("cpu", None)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("VOLT_PP_GENERAL", "0")
    assert profile_parts.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "base_fwd_general" not in line["ms_per_frame"]
    assert line["general_sweep_calls"] == 0
