"""Driver "frames": one viewer in a closed loop, each request a camera,
each answer a finished RGBA frame in host memory.

A frame, on the program's entry points: the plan (render.plan_for, or
ops.sweep.plan_sweep at the path's shared base dims, in set-up where the
cell reuses plans), with shadows the light volume
(ops.lighting.light_transmittance_volume), then render.render_image with
plan= and light_volume=, then a copy into a pinned host buffer, as a
viewer's client keeps one (serve.py does). The latency of a request runs
from its camera to its frame in host memory.

Workload keys: "traffic" (traffic.py); "plans": "setup" (one plan per
orbit camera at its own dims, built in set-up), "setup_shared" (the same
at the orbit's shared dims, cli.animation_base_dims) or "per_frame" (a
new plan in every request); "sample": answers kept for the check, a
reservoir drawn from the seed; "profile": [first, count] of the frames a
traced run profiles; "limits".

The check: each kept frame against the reference's frame of its camera,
with the plan and, with shadows, the light volume worked out again by the
reference; with shadows also each kept light volume against the
reference's. Numbers: the relative L2 error of the frame (all four
channels) and of the light volume, the worst over the kept answers.
"""
from __future__ import annotations

import random
import time

import torch

from benchmark import plan as bplan
from benchmark import reference, scene
from benchmark.profiling import Stretch
from benchmark.traffic import Traffic


class State:
    def __init__(self, ctx):
        self.grid = scene.make_grid(ctx.config["volume"], ctx.seed,
                                    ctx.device)
        self.traffic = Traffic(ctx.workload["traffic"], ctx.config["camera"],
                               ctx.seed)
        self.mode = ctx.workload["plans"]
        self.plans, self.program = {}, None
        self.ref_dims = None
        self.host = {}  # a pinned host buffer per frame shape

    def release(self):
        self.plans, self.program = {}, None


class Program:
    """The program's entry points, imported when a run starts."""

    def __init__(self, ctx, grid):
        from volumetricrenderer_tpu_torch.cli import animation_base_dims
        from volumetricrenderer_tpu_torch.ops.camera import look_at_camera
        from volumetricrenderer_tpu_torch.ops.lighting import \
            light_transmittance_volume
        from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep
        from volumetricrenderer_tpu_torch.render import plan_for, render_image
        self.look_at, self.plan_for, self.plan_sweep = (look_at_camera,
                                                        plan_for, plan_sweep)
        self.base_dims, self.light, self.render = (
            animation_base_dims, light_transmittance_volume, render_image)
        self.cfg, self.medium, self.lightc = ctx.program_configs()
        self.grid, self.device, self.shadows = grid, ctx.device, ctx.shadows

    def camera(self, cam):
        return self.look_at(cam["eye"], cam["center"], cam["up"],
                            cam["fov_y_degrees"], cam["width"], cam["height"])


def _span(spans, name, fn, device):
    """fn() under a "bench.<name>" host annotation in a traced run
    (spans not None); timed between two synchronizations into
    spans[name] unless the frame is profiled (spans["off"])."""
    if spans is None:
        return fn()
    timed = not spans.get("off") and device is not None
    if timed:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench." + name):
        out = fn()
    if timed:
        torch.cuda.synchronize(device)
        spans.setdefault(name, []).append(time.perf_counter() - t0)
    return out


def frame(state, cam, spans=None):
    """One request: (frame in host memory, the light volume or None)."""
    p = state.program
    pcam = p.camera(cam)
    dev = p.device if p.device.type == "cuda" else None
    if state.mode == "per_frame":
        plan = _span(spans, "plan", lambda: p.plan_for(
            pcam, p.grid.shape, p.cfg, device=p.device), dev)
    else:
        plan = state.plans[cam["index"]]
    lv = None
    if p.shadows:
        lv = _span(spans, "light",
                   lambda: p.light(p.grid, p.lightc, p.cfg, p.medium), dev)
    notes = None if spans is None else {"off": True}  # annotated, untimed
    with torch.no_grad():
        img = _span(notes, "render", lambda: p.render(
            p.grid, pcam, p.cfg, p.medium, p.lightc, plan=plan,
            light_volume=lv), dev)
    return _span(notes, "copy", lambda: _deliver(state, img), dev), lv


def _deliver(state, img):
    """The frame copied into the host buffer of its shape (made once)."""
    buf = state.host.get(img.shape)
    if buf is None:
        buf = state.host[img.shape] = torch.empty(
            img.shape, dtype=img.dtype, pin_memory=img.is_cuda)
    return buf.copy_(img)


def setup(ctx):
    state = State(ctx)
    state.program = p = Program(ctx, state.grid)
    ring = state.traffic.ring
    if state.mode in ("setup", "setup_shared"):
        dims = None
        if state.mode == "setup_shared":
            dims = p.base_dims([p.camera(c) for c in ring], p.grid.shape,
                               p.cfg)
        for cam in ring:
            if dims is None:
                state.plans[cam["index"]] = p.plan_for(
                    p.camera(cam), p.grid.shape, p.cfg, device=ctx.device)
            else:
                state.plans[cam["index"]] = p.plan_sweep(
                    p.camera(cam), p.grid.shape, p.cfg,
                    supersample=p.cfg.sweep_supersample,
                    force_base_dims=dims, device=ctx.device)
        warm = ring
    else:
        warm = [state.traffic.warmup()]
    for cam in warm:
        frame(state, cam)
    if ctx.trace:
        Stretch(ctx.device).warm()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return state


class Reservoir:
    """k answers drawn uniformly from a stream, by a seeded generator."""

    def __init__(self, k, seed):
        self.k, self.rng, self.items, self.n = k, random.Random(seed), [], 0

    def offer(self, make):
        """make() builds the item, called only if it is kept."""
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = make()
        self.n += 1


def window(ctx, state):
    first, count = ctx.workload["profile"]
    stretch = Stretch(ctx.device) if ctx.trace else None
    spans = {} if ctx.trace else None
    keep = Reservoir(int(ctx.workload["sample"]), ctx.seed + 1)
    lat, profiled_cams = [], []
    t0 = time.perf_counter()
    end, t_last = t0 + ctx.seconds, t0
    while not lat or time.perf_counter() < end:
        i = len(lat)
        profiled = stretch is not None and first <= i < first + count
        if profiled and i == first:
            stretch.start()
        cam = state.traffic.next()
        tr = time.perf_counter()
        host, lv = frame(state, cam,
                         None if spans is None else
                         {"off": True} if profiled else spans)
        t_last = time.perf_counter()
        lat.append(t_last - tr)
        if profiled:
            profiled_cams.append(cam)
            if i == first + count - 1:
                stretch.stop()
        keep.offer(lambda: (cam, host.clone(), lv))
    run = {"t0": t0, "window_s": t_last - t0, "latencies_s": lat,
           "frames": len(lat), "attempted": len(lat), "failed": 0,
           "answers": keep.items, "spans": spans or {}}
    if stretch is not None and stretch.finish() is not None:
        run["profile"] = stretch.summary
        run["profiled_work"] = [
            {"grid": state.grid, "camera": cam, "dims": _dims(ctx, state),
             "launches": {"sweep_fwd": 1}, "light": ctx.shadows}
            for cam in profiled_cams]
    return run


def _dims(ctx, state):
    """The base dims the reference plans at: the path's shared dims
    (worked out once), or None for each camera's own."""
    if state.mode != "setup_shared":
        return None
    if state.ref_dims is None:
        state.ref_dims = bplan.shared_dims(
            state.traffic.ring, state.grid.shape,
            ctx.config["render"]["sweep_supersample"])
    return state.ref_dims


def reference_plan(ctx, state, cam):
    return bplan.make_plan(cam, state.grid.shape, ctx.device,
                           ctx.config["render"]["sweep_supersample"],
                           _dims(ctx, state))


def check(ctx, state, run, answers=None):
    """The numbers compared, [(name, value, limit)]: the kept answers (or
    `answers`, as the control passes its own) against the reference."""
    answers = run["answers"] if answers is None else answers
    lv_ref = None
    if ctx.shadows:
        with torch.no_grad():
            lv_ref = reference.light_volume(state.grid, ctx.med)
    frame_err, light_err = 0.0, 0.0
    refs = {}
    for cam, host, lv in answers:
        key = tuple(cam["eye"])
        if key not in refs:
            with torch.no_grad():
                refs[key] = reference.render(
                    state.grid, reference_plan(ctx, state, cam), ctx.med,
                    lv_ref)
        ref = refs[key]
        got = host.to(ctx.device, torch.float32)
        frame_err = max(frame_err, _rel(got, ref))
        if lv_ref is not None:
            light_err = max(light_err, _rel(lv.float(), lv_ref))
    out = [("frame_rel_err", frame_err, ctx.limit("frame_rel_err"))]
    if ctx.shadows:
        out.append(("light_rel_err", light_err, ctx.limit("light_rel_err")))
    return out


def _rel(got, ref):
    if got.shape != ref.shape:
        return float("inf")
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def control(ctx, fault=None):
    """(state, answers) of the control in the program's place: the
    reference in TF32 (fault None or "tf32") at the first `sample`
    cameras of the run's traffic."""
    if fault not in (None, "tf32"):
        raise ValueError(f"no fault {fault!r} for the frames driver")
    state = State(ctx)
    lv = None
    with torch.no_grad():
        if ctx.shadows:
            lv = reference.light_volume(state.grid, ctx.med, tf32=True)
        answers = []
        for _ in range(int(ctx.workload["sample"])):
            cam = state.traffic.next()
            img = reference.render(state.grid, reference_plan(ctx, state, cam),
                                   ctx.med, lv, tf32=True)
            answers.append((cam, img.cpu(), lv))
    return state, answers
