"""Driver "fit_ref": the inverse rendering of the 4-channel reference
medium, through the program's entry volumetricrenderer_tpu_torch.fit.
fit_grid, shaped as drivers/fit.py (whose pieces this one imports).

Set-up: the target is reference_ref's render of scene_ref's seeded grid
from the configuration's own camera. fit_grid then starts from its own
constant 0.1 grid in all four channels (Adam at the cell's learning rate,
the clamp to [0, 1], no scroll) and runs `checked_steps` steps, handing
the grid and the Adam state of every step to a checkpoint callback; the
program then renders the grid of the last checked step (render_image).
Those steps and that frame are what the check compares. The timing steps
and the window are drivers/fit.py's: a resumed call of `timing_steps`
times a step, and the window is one more resumed fit_grid call with as
many steps as fill `--seconds` at that pace. A step its NaN guard skips
counts as failed.

Workload keys: "traffic" (traffic.py), "fit" (grid_size, learning_rate),
"checked_steps", "timing_steps", "profile" (drivers/fit.py's), "limits".
The program's configuration objects are made from the configuration file
with its lists as tuples.

The check, against reference_ref_fit.fit_steps over the same target,
camera and steps: drivers/fit.py's loss_gap, grad_norm_gap and
change_norm_gap, and frame_rel_err, the relative L2 error (all four
channels) of the program's frame of its checked grid against
reference_ref's frame of that grid. On stderr, the 4-channel kernels'
launches per fit step over the window (one of each).
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from benchmark import harness, reference_ref, reference_ref_fit, scene_ref
from benchmark import plan as bplan
from benchmark.drivers import fit, frames
from benchmark.profiling import Stretch
from benchmark.traffic import Traffic


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class State:
    def __init__(self, ctx):
        c, settings = ctx.config, ctx.workload["fit"]
        self.size = int(settings["grid_size"])
        self.lr = float(settings["learning_rate"])
        self.cam = Traffic(ctx.workload["traffic"], c["camera"],
                           ctx.seed).next()
        true_grid = scene_ref.make_grid(c["volume"], ctx.seed, ctx.device)
        self.plan = bplan.make_plan(self.cam, true_grid.shape[:3],
                                    ctx.device,
                                    c["render"]["sweep_supersample"])
        self.target = reference_ref.render(true_grid, self.plan,
                                           ctx.med)[..., :3].contiguous()
        self.fit = None
        self.args = None

    def release(self):
        self.fit, self.args = None, None


def _program(ctx, state):
    from volumetricrenderer_tpu_torch.config import (LightConfig,
                                                     MediumConfig,
                                                     RenderConfig)
    from volumetricrenderer_tpu_torch.fit import fit_grid
    from volumetricrenderer_tpu_torch.ops.camera import look_at_camera
    c, cam = ctx.config, state.cam
    pcam = look_at_camera(cam["eye"], cam["center"], cam["up"],
                          cam["fov_y_degrees"], cam["width"], cam["height"])
    state.fit = fit_grid
    state.args = (state.target, pcam, RenderConfig(**_tuples(c["render"])),
                  MediumConfig(**_tuples(c["medium"])),
                  LightConfig(**_tuples(c["light"])))


def _frame(state, grid):
    """The program's frame of `grid`: render_image, looked up when called."""
    render = importlib.import_module("volumetricrenderer_tpu_torch.render")
    _, pcam, cfg, medium, light = state.args
    with torch.no_grad():
        return render.render_image(grid, pcam, cfg, medium, light).clone()


def setup(ctx):
    state = State(ctx)
    _program(ctx, state)
    checked = int(ctx.workload["checked_steps"])
    timing = int(ctx.workload["timing_steps"])
    rec = []

    def keep(step, grid, leaves):
        # On the CPU the leaves are views of the live Adam state.
        rec.append((step, grid.clone(), [np.array(x) for x in leaves]))

    res = fit._call(state, checked, checkpoint_fn=keep, checkpoint_every=1)
    state.losses = list(res.losses)
    state.g1 = torch.as_tensor(np.asarray(rec[0][2][1])).to(ctx.device) \
        / (1.0 - fit.BETA1)
    state.grid = rec[-1][1]
    state.change = state.grid - reference_ref_fit.INIT
    state.frame = _frame(state, state.grid)
    state.skipped_setup = res.skipped_steps
    # drivers/fit.py's pace: a resumed call of `timing` steps, timed
    # between fit_grid's tenth-step metric writes.
    clock, last = fit._Clock(), []
    t = time.perf_counter()
    res = fit._call(state, checked + timing, init_grid=state.grid,
                    init_opt_state=rec[-1][2], start_step=checked,
                    metrics=clock,
                    checkpoint_fn=lambda s, g, leaves: last.append(
                        (g.clone(), [np.array(x) for x in leaves])),
                    checkpoint_every=checked + timing)
    call = time.perf_counter() - t
    state.skipped_setup += res.skipped_steps
    per_step = clock.per_step(call / timing)
    state.resume = (*last[-1], checked + timing)
    state.window_steps = max(1, int(round(
        (ctx.seconds - max(call - timing * per_step, 0.0)) / per_step)))
    if ctx.trace:
        Stretch(ctx.device).warm()
    return state


def _ref_launches():
    from volumetricrenderer_tpu_torch.kernels import (sweep_ref_bwd,
                                                      sweep_ref_fwd)
    return sweep_ref_fwd.launches, sweep_ref_bwd.launches


def window(ctx, state):
    """drivers/fit.py's window; the profiled work names the 4-channel
    kernels, one launch of each a step."""
    before = _ref_launches()
    run = fit.window(ctx, state)
    k4, k5 = (b - a for a, b in zip(before, _ref_launches()))
    harness.log(f"4-channel kernels over the window, per step "
                f"({run['steps']}): sweep_ref_fwd.launches "
                f"{k4 / run['steps']:g}, sweep_ref_bwd.launches "
                f"{k5 / run['steps']:g}")
    for item in run.get("profiled_work", []):
        n = item["launches"]["sweep_fwd"]
        item["launches"] = {"sweep_ref_fwd": n, "sweep_ref_bwd": n}
        item["scroll"] = None
    return run


def check(ctx, state, run, answers=None):
    """[(name, value, limit)]: the program's checked steps and frame (or
    `answers`, (losses, first gradient, change, grid, frame), as the
    control passes its own) against reference_ref_fit.fit_steps and
    reference_ref's frame of the same grid."""
    losses, g1, change, grid, frame = (
        answers if answers is not None else
        (state.losses, state.g1, state.change, state.grid, state.frame))
    n = len(state.losses)
    ref_losses, ref_g1, ref_change, _ = reference_ref_fit.fit_steps(
        state.target, state.plan, ctx.med, state.size, state.lr, n)
    ref_frame = reference_ref.render(grid.to(ctx.device), state.plan,
                                     ctx.med)
    out = [
        ("loss_gap", max(abs(a - b) / abs(b)
                         for a, b in zip(losses, ref_losses)),
         ctx.limit("loss_gap")),
        ("grad_norm_gap", fit._norm_gap(g1, ref_g1),
         ctx.limit("grad_norm_gap")),
        ("change_norm_gap", fit._norm_gap(change, ref_change),
         ctx.limit("change_norm_gap")),
        ("frame_rel_err", frames._rel(frame.to(ctx.device, torch.float32),
                                      ref_frame),
         ctx.limit("frame_rel_err")),
    ]
    if state.skipped_setup:
        out.append(("skipped_checked_steps", float(state.skipped_setup), 0))
    return out


def control(ctx, fault=None):
    """(state, answers) of the control in the program's place: the
    reference's checked steps and its frame of their grid in TF32 (fault
    None or "tf32"), or in float32 with half of the batch, the bottom half
    of the rows, left out of the loss ("half_batch")."""
    if fault not in (None, "tf32", "half_batch"):
        raise ValueError(f"no fault {fault!r} for the fit_ref driver")
    state = State(ctx)
    n = int(ctx.workload["checked_steps"])
    state.losses, state.skipped_setup = [None] * n, 0
    tf32 = fault in (None, "tf32")
    losses, g1, change, grid = reference_ref_fit.fit_steps(
        state.target, state.plan, ctx.med, state.size, state.lr, n,
        tf32=tf32, half_batch=fault == "half_batch")
    frame = reference_ref.render(grid, state.plan, ctx.med, tf32=tf32)
    return state, (losses, g1, change, grid, frame)
