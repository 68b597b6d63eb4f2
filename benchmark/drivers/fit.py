"""Driver "fit": the inverse-rendering deployment, through the program's
entry volumetricrenderer_tpu_torch.fit.fit_grid.

Set-up: the target is the reference's render of the configuration's
seeded scene from its own camera. fit_grid then starts from its own
constant 0.1 grid (Adam at the configuration's learning rate) and runs
`checked_steps` steps, handing the grid and the Adam state of every step
to a checkpoint callback: those steps are what the check compares. It
resumes from that state (fit_grid's init_grid, init_opt_state,
start_step) for `timing_steps` more, which time a step between its metric
writes; the window is one more fit_grid call, resumed from there, with as
many steps as fill `--seconds` at that pace. The window's time is the whole call: its plan
build, its resume, every step's syncs. A step its NaN guard skips counts
as failed.

A traced run profiles the steps between two of fit_grid's metric writes
("profile": [after the write at step a, to the write at step b]) and
keeps the grid at both ends for the roofline count.

The check, against reference.fit_steps over the same target, camera and
steps: each step's loss (the worst relative gap), the norm of the first
gradient as the optimizer got it (its Adam first moment after one step,
divided by 1 - beta1 = 0.1), and the norm of the grid's change after the
checked steps, each as the relative gap between the program's norm and
the reference's.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.optim.optimizer as topt

from benchmark import plan as bplan
from benchmark import reference, scene
from benchmark.profiling import Stretch
from benchmark.traffic import Traffic

BETA1 = 0.9


class State:
    def __init__(self, ctx):
        c = ctx.config
        self.size = int(c["fit"]["grid_size"])
        self.lr = float(c["fit"]["learning_rate"])
        self.cam = Traffic(ctx.workload["traffic"], c["camera"],
                           ctx.seed).next()
        true_grid = scene.make_grid(c["volume"], ctx.seed, ctx.device)
        self.plan = bplan.make_plan(self.cam, true_grid.shape, ctx.device,
                                    c["render"]["sweep_supersample"])
        with torch.no_grad():
            self.target = reference.render(true_grid, self.plan,
                                           ctx.med)[..., :3].contiguous()
        self.fit = None
        self.args = None

    def release(self):
        self.fit, self.args = None, None


def _program(ctx, state):
    from volumetricrenderer_tpu_torch.fit import fit_grid
    from volumetricrenderer_tpu_torch.ops.camera import look_at_camera
    cfg, medium, light = ctx.program_configs()
    cam = state.cam
    pcam = look_at_camera(cam["eye"], cam["center"], cam["up"],
                          cam["fov_y_degrees"], cam["width"], cam["height"])
    state.fit = fit_grid
    state.args = (state.target, pcam, cfg, medium, light)


def _call(state, steps, **kw):
    return state.fit(*state.args, grid_size=state.size, steps=steps,
                     learning_rate=state.lr, **kw)


def setup(ctx):
    state = State(ctx)
    _program(ctx, state)
    checked = int(ctx.workload["checked_steps"])
    timing = int(ctx.workload["timing_steps"])
    rec = []

    def keep(step, grid, leaves):
        # On the CPU the leaves are views of the live Adam state.
        rec.append((step, grid.clone(), [np.array(x) for x in leaves]))

    res = _call(state, checked, checkpoint_fn=keep, checkpoint_every=1)
    state.losses = list(res.losses)
    state.g1 = torch.as_tensor(np.asarray(rec[0][2][1])).to(ctx.device) \
        / (1.0 - BETA1)
    state.change = rec[-1][1] - 0.1
    state.skipped_setup = res.skipped_steps
    # One resumed call of `timing` steps times a step between fit_grid's
    # metric writes (every tenth step, each after the step's loss has
    # reached the host); the rest of the call is the call's own cost (its
    # plan, its resume), which the window's call pays once too.
    clock, last = _Clock(), []
    t = time.perf_counter()
    res = _call(state, checked + timing, init_grid=rec[-1][1],
                init_opt_state=rec[-1][2], start_step=checked, metrics=clock,
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


class _Clock:
    """fit_grid's metrics sink: the host clock at each write."""

    def __init__(self):
        self.marks = []

    def write(self, step, **_):
        self.marks.append((step, time.perf_counter()))

    def per_step(self, fallback):
        """Seconds a step between the first and the last tenth-step write
        (the last write, of the call's last step, is left out); fallback
        where fewer than two such writes were made."""
        tenth = [m for m in self.marks[:-1] if m[0] % 10 == 0]
        if len(tenth) < 2:
            return fallback
        (s0, t0), (s1, t1) = tenth[0], tenth[-1]
        return (t1 - t0) / (s1 - s0)


class _Profiled:
    """fit_grid's metrics sink in a traced run: starts the stretch at the
    write of step a and ends it at the write of step b, keeping the grid
    (found through an optimizer step hook) at both ends."""

    def __init__(self, device, a, b):
        self.stretch, self.a, self.b = Stretch(device), a, b
        self.param, self.grids = None, []
        self.handle = topt.register_optimizer_step_post_hook(self._hook)

    def _hook(self, optimizer, args, kwargs):
        self.param = optimizer.param_groups[0]["params"][0]

    def write(self, step, **_):
        if step == self.a:
            self.grids.append(self.param.detach().clone())
            self.stretch.start()
        elif step == self.b and self.stretch.running:
            self.stretch.stop()
            self.grids.append(self.param.detach().clone())


def window(ctx, state):
    grid, leaves, start = state.resume
    steps = state.window_steps
    prof = None
    kw = {}
    if ctx.trace:
        a = (start // 10 + 1) * 10 + 10 * int(ctx.workload["profile"][0])
        prof = _Profiled(ctx.device, a, a + 10 * int(ctx.workload[
            "profile"][1]))
        kw["metrics"] = prof
    t0 = time.perf_counter()
    try:
        res = _call(state, start + steps, init_grid=grid,
                    init_opt_state=leaves, start_step=start, **kw)
    finally:
        if prof is not None:
            prof.handle.remove()
    t1 = time.perf_counter()
    pixels = int(state.target.shape[0] * state.target.shape[1])
    run = {"t0": t0, "window_s": t1 - t0, "steps": steps,
           "rays_per_step": pixels, "attempted": steps,
           "failed": res.skipped_steps, "spans": {}}
    if prof is not None and prof.stretch.finish() is not None \
            and len(prof.grids) == 2:
        run["profile"] = prof.stretch.summary
        n = prof.b - prof.a
        run["profiled_work"] = [
            {"grid": g, "camera": state.cam, "dims": None,
             "launches": {"sweep_fwd": n / 2, "sweep_bwd": n / 2},
             "light": False} for g in prof.grids]
    return run


def check(ctx, state, run, answers=None):
    """[(name, value, limit)]: the program's checked steps (or `answers`,
    (losses, first gradient, change), as the control passes its own)
    against reference.fit_steps."""
    losses, g1, change = (answers if answers is not None
                          else (state.losses, state.g1, state.change))
    n = len(state.losses)
    ref_losses, ref_g1, ref_change = reference.fit_steps(
        state.target, state.plan, ctx.med, state.size, state.lr, n)
    out = [
        ("loss_gap", max(abs(a - b) / abs(b)
                         for a, b in zip(losses, ref_losses)),
         ctx.limit("loss_gap")),
        ("grad_norm_gap", _norm_gap(g1, ref_g1), ctx.limit("grad_norm_gap")),
        ("change_norm_gap", _norm_gap(change, ref_change),
         ctx.limit("change_norm_gap")),
    ]
    if state.skipped_setup:
        out.append(("skipped_checked_steps", float(state.skipped_setup), 0))
    return out


def _norm_gap(got, ref):
    rn = float(torch.linalg.vector_norm(ref))
    return abs(float(torch.linalg.vector_norm(got.float())) - rn) / rn


def control(ctx, fault=None):
    """(state, answers) of the control in the program's place: the
    reference's checked steps in TF32 (fault None or "tf32"), or in
    float32 with half of the batch, the bottom half of the rows, left out
    of the loss ("half_batch")."""
    state = State(ctx)
    n = int(ctx.workload["checked_steps"])
    state.losses, state.skipped_setup = [None] * n, 0
    answers = reference.fit_steps(
        state.target, state.plan, ctx.med, state.size, state.lr, n,
        tf32=fault in (None, "tf32"), half_batch=fault == "half_batch")
    return state, answers
