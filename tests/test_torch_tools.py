"""The port's runners (volumetricrenderer_tpu_torch/tools/, the JAX
repository's workload tools under tools/) on the CPU at small sizes,
against the JAX package where it composes the same workload. The JAX side
is composed as each JAX tool composes it; no JAX tool's main() runs (it
writes its artifact into the working directory).

* fit_config3 at 12^3 / 24x24, 3 steps: the line's losses are the timed
  fit's on the runner's workload (tests/test_torch_fit.py holds that fit
  to JAX fit_grid on JAX's baked target, rtol 1e-4, at its module
  fixture's 16^3 / 48x48);
* anim_config4 at 16^3 / 48x32, 3 frames: each frame against JAX
  render_image on animation_plans' plan and the JAX light volume, rtol
  2e-4, atol 2e-5 (tests/test_sweep_pallas.py's, as the port's frames are
  held throughout);
* scale512 at 16^3 / 48x32, 16, 8 and 4 slices: the frame against JAX
  sweep_render at n_slices (rtol 2e-4, atol 1e-4: the port's own plan,
  whose warp coordinates differ from JAX's by float32 rounding, as
  tests/test_torch_render.py holds render_image) and the grid gradient of
  sum(rgb^2) against jax.grad (rtol 2e-4, atol 2e-4 * max, at JAX's
  "highest" matmul precision, as tests/test_torch_render.py);
* serve_local at 48^2 (16^3), K = 4: each timed frame equals
  render_frame() at its state bit for bit (tests/test_torch_serve.py
  holds the walk to the JAX InteractiveRenderer's);
* measure_warp and trace_flagship: main() with --device cpu;
* every runner: one JSON line last on stdout with its keys, no file
  written without --out (the line in the file with it), no kernel launch
  and no general sweep on the CPU, and the default device fails without a
  GPU.
"""
import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu as J
from volumetricrenderer_tpu.cli import animation_plans
from volumetricrenderer_tpu.ops import sweep as jsweep
from volumetricrenderer_tpu.ops.lighting import light_transmittance_volume
from volumetricrenderer_tpu_torch.tools import (RUNNERS, anim_config4,
                                                fit_config3, scale512,
                                                serve_local)

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
NO_LAUNCH = {"sweep_fwd": 0, "sweep_bwd": 0, "sweep_ref_fwd": 0,
             "sweep_ref_bwd": 0}
COMMON = ("device", "power_limit_w", "timed_runs", "launches",
          "general_sweep_calls")
SMALL = {  # each runner's size cut, and the keys of its line
    "fit_config3": (
        {"VOLT_F_SIZE": "12", "VOLT_F_IMG": "24", "VOLT_F_STEPS": "3"},
        ("config", "volume", "image", "steps", "loss_first", "loss_last",
         "loss_drop_x", "losses_every_5", "losses", "skipped_steps",
         "fit_s", "ms_per_step", "host_ms_per_step", "setup_s",
         "total_s")),
    "anim_config4": (
        {"VOLT_A_FRAMES": "3", "VOLT_A_VOLUME": "16", "VOLT_A_WIDTH": "48",
         "VOLT_A_HEIGHT": "32"},
        ("config", "volume", "width", "height", "shadow", "frames",
         "fps_wall", "ms_per_frame_wall", "ms_per_frame",
         "host_ms_per_frame", "mrays_per_s", "plan_s", "setup_s", "total_s",
         "warmup_runs")),
    "scale512": (
        {"VOLT_S_FRAMES": "1", "VOLT_S_SLICES": "16,8", "VOLT_S_VOLUME": "16",
         "VOLT_S_WIDTH": "48", "VOLT_S_HEIGHT": "32"},
        ("config", "volume", "width", "height", "grid_bytes_mb",
         "base_shape", "slice_note", "by_slices", "ms_per_frame_fwd",
         "ms_per_frame_fwd_bwd", "mrays_per_s_fwd_bwd", "peak_memory_gib",
         "total_s", "warmup_runs")),
    "serve_local": (
        {"VOLT_SL_SIZE": "48", "VOLT_SL_K": "4", "VOLT_SL_ITERS": "1",
         "VOLT_SL_VOLUME": "16"},
        ("what", "preset", "volume", "width", "height", "states", "iters",
         "init_s", "plan_build_s", "ms_per_frame_device",
         "fps_device_paced", "host_ms_per_frame", "ms_per_round_all",
         "force_dims", "note", "warmup_runs")),
    "measure_warp": (
        {"VOLT_W_FRAMES": "2", "VOLT_W_ITERS": "1", "VOLT_W_VOLUME": "16",
         "VOLT_W_WIDTH": "48", "VOLT_W_HEIGHT": "32"},
        ("base_shape", "channels", "moveaxis_only", "ms_fwd", "host_ms_fwd",
         "ms_fwd_bwd", "host_ms_fwd_bwd", "splat_ms_all",
         "splat_ms_footprint", "splat_ms_own_texels", "pixels",
         "footprint_pixels", "warmup_runs")),
    "trace_flagship": (
        {"V": "16", "W": "48", "H": "32", "K": "2"},
        ("volume", "width", "height", "steps", "fwd_only", "base_shape",
         "slices", "wall_ms_per_step", "busy_ms_per_step", "idle_share",
         "ops_clock", "top_ops", "warmup_runs")),
}


def _module(name):
    return importlib.import_module(
        f"volumetricrenderer_tpu_torch.tools.{name}")


def _main(name, monkeypatch, capsys, tmp_path, *args):
    """main(["--device", "cpu", *args]) at the runner's small size in an
    empty working directory: returns the last stdout line, parsed, after
    checking its keys, the CPU's fields and that no file was written
    (unless --out)."""
    env, keys = SMALL[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    assert _module(name).main(["--device", "cpu", *args]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert set(keys + COMMON) <= set(line), set(keys + COMMON) - set(line)
    assert (line["device"], line["power_limit_w"]) == ("cpu", None)
    assert line["launches"] == NO_LAUNCH  # the plain versions run
    assert line["general_sweep_calls"] == 0
    if "--out" not in args:
        assert list(tmp_path.iterdir()) == []
    return line


def test_runners_are_the_six():
    assert RUNNERS == tuple(SMALL)


def test_fit_config3_line(monkeypatch, capsys, tmp_path):
    """The line's losses are those of the runner's timed fit on its
    workload (tests/test_torch_fit.py holds both to the JAX fit)."""
    line = _main("fit_config3", monkeypatch, capsys, tmp_path)
    res = fit_config3.fit(*fit_config3.workload(12, 24, "cpu"), 12, 3)
    assert line["losses"] == res.losses
    assert line["skipped_steps"] == res.skipped_steps == 0
    assert (line["loss_first"], line["loss_last"]) == (res.losses[0],
                                                       res.losses[-1])
    assert line["losses_every_5"] == res.losses[:1]
    assert line["loss_drop_x"] == res.losses[0] / res.losses[-1] > 1.0
    assert (line["volume"], line["image"], line["steps"]) == (12, 24, 3)
    assert line["timed_runs"] == 2  # the steps between fit_grid's writes


def test_anim_config4_frames_match_jax(monkeypatch, capsys, tmp_path):
    frames = 3
    preset, grid, cams = anim_config4.workload(frames, 16, 48, 32, "cpu")
    plans = anim_config4.plans_for(cams, grid, preset.render, "cpu")
    jp = J.get_preset("config4")
    jcams = [J.orbit_camera(2 * math.pi * i / frames,
                            fov_y_degrees=jp.camera.fov_y_degrees, width=48,
                            height=32) for i in range(frames)]
    jgrid = jnp.asarray(grid.numpy())
    jplans, _ = animation_plans(jcams, jgrid.shape, jp.render)
    lv = light_transmittance_volume(jgrid, jp.light, jp.render, jp.medium)
    # the JAX tool's frame, jitted as there (a plan per compile)
    jframe = jax.jit(lambda g, plan, lv: J.render_image(
        g, None, jp.render, jp.medium, jp.light, plan=plan, light_volume=lv,
        backend="sweep"))
    for i in range(frames):
        assert plans[i].base_shape == tuple(jplans[i].base_shape)
        want = jframe(jgrid, jplans[i], lv)
        got = anim_config4.frame(grid, plans[i], preset)
        assert got.shape == (32, 48, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    line = _main("anim_config4", monkeypatch, capsys, tmp_path)
    assert (line["frames"], line["timed_runs"], line["volume"]) == (3, 3, 16)


@pytest.mark.parametrize("slices", [16, 8, 4])
def test_scale512_frame_and_gradient_match_jax(slices):
    grid, cam, cfg, med = scale512.workload(16, 48, 32, "cpu")
    plan = scale512.plan_at(cam, grid, cfg, slices)
    assert plan.slice_z.shape[0] == slices
    jcfg = J.RenderConfig(emission=True, quadrature="sliced")
    jmed = J.MediumConfig(combine="single", density=8.0)
    jcam = J.make_camera(J.CameraConfig(width=48, height=32))
    jplan = jsweep.plan_sweep(jcam, (16,) * 3, jcfg,
                              n_slices=None if slices == 16 else slices)
    jgrid = jnp.asarray(grid.numpy())

    def loss(g):
        img = jsweep.sweep_render(g, jplan, jcfg, jmed)
        return jnp.sum(img[..., :3] ** 2), img

    with jax.default_matmul_precision("highest"):
        (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jgrid)
    got = scale512.fwd(grid, plan, cfg, med)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-4)
    g = grid.clone().requires_grad_()
    got_fb = scale512.fwd_bwd(g, plan, cfg, med)
    assert torch.equal(got_fb, got)
    want_g = np.asarray(want_g)
    scale = float(np.abs(want_g).max())
    assert scale > 0.0
    np.testing.assert_allclose(g.grad.numpy(), want_g, rtol=RTOL,
                               atol=RTOL * scale)


def test_scale512_main(monkeypatch, capsys, tmp_path):
    line = _main("scale512", monkeypatch, capsys, tmp_path)
    assert set(line["by_slices"]) == {"16", "8"}
    for row in line["by_slices"].values():
        assert row["launches_fwd"] == row["launches_fwd_bwd"] == NO_LAUNCH
        assert row["mrays_per_s_fwd_bwd"] > 0.0
    assert line["ms_per_frame_fwd"] == \
        line["by_slices"]["16"]["ms_per_frame_fwd"]
    assert line["grid_bytes_mb"] == 16 ** 3 * 4 / 2 ** 20


def test_serve_local_frames(monkeypatch, capsys, tmp_path):
    """Each timed frame equals render_frame() at its walked state, on a
    fresh renderer given the same keys (tests/test_torch_serve.py holds
    the walk to the JAX renderer's)."""
    k = 4
    r = serve_local.workload(48, 16, "cpu")
    states = serve_local.walk(r, k)
    frames = serve_local.frames(r, [r._plan_cached(*s) for s in states])
    r2, want = serve_local.workload(48, 16, "cpu"), []
    for key in serve_local.KEYS:
        r2.key(key)
        if (r2.azim, r2.elev, r2.dist) == states[len(want)]:
            want.append(r2.render_frame())
        if len(want) == k:
            break
    assert len(want) == len(frames) == k
    for got, w in zip(frames, want):
        assert got.dtype == torch.uint8 and got.shape == (48, 48, 3)
        np.testing.assert_array_equal(got.numpy(), w)
    line = _main("serve_local", monkeypatch, capsys, tmp_path)
    assert (line["states"], line["preset"], line["volume"]) == (k, "config2",
                                                                16)
    assert len(line["ms_per_round_all"]) == line["timed_runs"] == 1


def test_measure_warp_main_and_out(monkeypatch, capsys, tmp_path):
    out = tmp_path / "warp.json"
    line = _main("measure_warp", monkeypatch, capsys, tmp_path, "--out",
                 str(out))
    assert [p.name for p in tmp_path.iterdir()] == ["warp.json"]
    assert json.loads(out.read_text()) == line
    assert line["timed_runs"] == 2 and line["channels"] == 2
    assert 0 < line["footprint_pixels"] <= line["pixels"] == 48 * 32


def test_trace_flagship_main(monkeypatch, capsys, tmp_path):
    line = _main("trace_flagship", monkeypatch, capsys, tmp_path)
    assert line["ops_clock"] == "host" and line["busy_ms_per_step"] is None
    assert 0 < len(line["top_ops"]) <= 15
    ms = [op["ms_per_step"] for op in line["top_ops"]]
    assert ms == sorted(ms, reverse=True) and ms[0] > 0.0
    assert (line["steps"], line["slices"], line["fwd_only"]) == (2, 16,
                                                                 False)


@pytest.mark.parametrize("name", RUNNERS)
def test_default_device_fails_without_a_gpu(name, monkeypatch, capsys,
                                            tmp_path):
    """--device defaults to cuda: with no GPU the runner fails with
    torch's own error, prints no line and writes no file."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    for k, v in SMALL[name][0].items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        _module(name).main([])
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []
