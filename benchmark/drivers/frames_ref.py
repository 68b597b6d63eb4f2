"""Driver "frames_ref": one viewer of the 4-channel reference medium in a
closed loop, each request a camera and a media time, each answer a
finished RGBA frame in host memory.

The driver "frames" (frames.py, whose pieces this one imports) with the
medium's scroll added: the orbit's cameras (the program's camera
objects, kept as a client keeps them) and their plans, each at its own
dims (render.plan_for), are built in set-up, and each camera's frame is
rendered twice there. Frame i of the window has media time t = i / "fps"
and scroll t * v on the device, v a (4, 3) velocity drawn from the seed,
uniform in +-"scroll_speed" (the scroll's units, in which the box spans
1, a second). A frame is
render.render_image with plan= and scroll=, then a copy into a pinned host
buffer. The grid is scene_ref's. The program's configuration objects are
made from the configuration file with its lists as tuples.

Workload keys: "traffic" (traffic.py), "scroll_speed", "fps", "sample"
(answers kept for the check, a reservoir drawn from the seed), "profile"
([first, count] of the frames a traced run profiles), "limits".

The check: each kept (camera, scroll, frame) against reference_ref's frame
of that camera and scroll, on the plan plan.py works out: frame_rel_err,
the relative L2 error of the frame (all four channels), the worst over the
kept answers. On stderr, the 4-channel kernels' launches per frame over
the window.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, reference_ref, scene_ref
from benchmark import plan as bplan
from benchmark.drivers import frames
from benchmark.profiling import Stretch
from benchmark.traffic import Traffic


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class State:
    def __init__(self, ctx):
        self.grid = scene_ref.make_grid(ctx.config["volume"], ctx.seed,
                                        ctx.device)
        self.traffic = Traffic(ctx.workload["traffic"], ctx.config["camera"],
                               ctx.seed)
        speed = float(ctx.workload["scroll_speed"])
        self.velocity = torch.tensor(
            np.random.default_rng(ctx.seed).uniform(-speed, speed, (4, 3)),
            dtype=torch.float32, device=ctx.device)
        self.fps = float(ctx.workload["fps"])
        self.plans, self.cameras, self.program = {}, {}, None
        self.host = {}  # a pinned host buffer per frame shape (frames.py)

    def scroll(self, i):
        """Frame i's (4, 3) scroll, on the device."""
        return self.velocity * (i / self.fps)

    def release(self):
        self.plans, self.cameras, self.program = {}, {}, None


class Program(frames.Program):
    """frames.Program's entry points, with the configuration's lists as
    tuples in the program's configuration objects."""

    def __init__(self, ctx, grid):
        super().__init__(ctx, grid)
        from volumetricrenderer_tpu_torch.config import (LightConfig,
                                                         MediumConfig,
                                                         RenderConfig)
        c = ctx.config
        self.cfg = RenderConfig(**_tuples(c["render"]))
        self.medium = MediumConfig(**_tuples(c["medium"]))
        self.lightc = LightConfig(**_tuples(c["light"]))


def frame(state, cam, scroll, traced=False):
    """One request: its frame in host memory. traced: the render and the
    copy under host annotations."""
    p = state.program
    dev = p.device if p.device.type == "cuda" else None
    notes = {"off": True} if traced else None
    with torch.no_grad():
        img = frames._span(notes, "render", lambda: p.render(
            p.grid, state.cameras[cam["index"]], p.cfg, p.medium, p.lightc,
            scroll=scroll, plan=state.plans[cam["index"]]), dev)
    return frames._span(notes, "copy", lambda: frames._deliver(state, img),
                        dev)


def setup(ctx):
    state = State(ctx)
    state.program = p = Program(ctx, state.grid)
    for cam in state.traffic.ring:
        state.cameras[cam["index"]] = p.camera(cam)
        state.plans[cam["index"]] = p.plan_for(
            state.cameras[cam["index"]], p.grid.shape, p.cfg,
            device=ctx.device)
    for _ in range(2):  # a renderer may set a camera up on its second frame
        for cam in state.traffic.ring:
            frame(state, cam, state.scroll(0))
    if ctx.trace:
        Stretch(ctx.device).warm()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return state


def _ref_launches():
    from volumetricrenderer_tpu_torch.kernels import (sweep_ref_bwd,
                                                      sweep_ref_fwd)
    return sweep_ref_fwd.launches, sweep_ref_bwd.launches


def window(ctx, state):
    first, count = ctx.workload["profile"]
    stretch = Stretch(ctx.device) if ctx.trace else None
    keep = frames.Reservoir(int(ctx.workload["sample"]), ctx.seed + 1)
    lat, profiled = [], []
    before = _ref_launches()
    t0 = time.perf_counter()
    end, t_last = t0 + ctx.seconds, t0
    while not lat or time.perf_counter() < end:
        i = len(lat)
        in_stretch = stretch is not None and first <= i < first + count
        if in_stretch and i == first:
            stretch.start()
        cam = state.traffic.next()
        tr = time.perf_counter()
        scroll = state.scroll(i)
        host = frame(state, cam, scroll, traced=ctx.trace)
        t_last = time.perf_counter()
        lat.append(t_last - tr)
        if in_stretch:
            profiled.append((cam, scroll))
            if i == first + count - 1:
                stretch.stop()
        keep.offer(lambda: (cam, scroll.clone(), host.clone()))
    fwd, bwd = (b - a for a, b in zip(before, _ref_launches()))
    harness.log(f"4-channel kernels over the window, per attempt "
                f"({len(lat)}): sweep_ref_fwd.launches {fwd / len(lat):g}, "
                f"sweep_ref_bwd.launches {bwd / len(lat):g}")
    run = {"t0": t0, "window_s": t_last - t0, "latencies_s": lat,
           "frames": len(lat), "attempted": len(lat), "failed": 0,
           "answers": keep.items, "spans": {}}
    if stretch is not None and stretch.finish() is not None:
        run["profile"] = stretch.summary
        run["profiled_work"] = [
            {"grid": state.grid, "camera": cam, "scroll": scroll,
             "launches": {"sweep_ref_fwd": 1}} for cam, scroll in profiled]
    return run


def check(ctx, state, run, answers=None):
    """The numbers compared, [(name, value, limit)]: the kept answers (or
    `answers`, as the control passes its own) against the reference."""
    answers = run["answers"] if answers is None else answers
    plans, err = {}, 0.0
    for cam, scroll, host in answers:
        key = tuple(cam["eye"])
        if key not in plans:
            plans[key] = bplan.make_plan(
                cam, state.grid.shape[:3], ctx.device,
                ctx.config["render"]["sweep_supersample"])
        ref = reference_ref.render(state.grid, plans[key], ctx.med, scroll)
        err = max(err, frames._rel(host.to(ctx.device, torch.float32), ref))
    return [("frame_rel_err", err, ctx.limit("frame_rel_err"))]


def control(ctx, fault=None):
    """(state, answers) of the control in the program's place: the
    reference in TF32 (fault None or "tf32") at the first `sample`
    requests of the run's traffic."""
    if fault not in (None, "tf32"):
        raise ValueError(f"no fault {fault!r} for the frames_ref driver")
    state = State(ctx)
    answers = []
    for i in range(int(ctx.workload["sample"])):
        cam = state.traffic.next()
        plan = bplan.make_plan(cam, state.grid.shape[:3], ctx.device,
                               ctx.config["render"]["sweep_supersample"])
        scroll = state.scroll(i)
        img = reference_ref.render(state.grid, plan, ctx.med, scroll,
                                   tf32=True)
        answers.append((cam, scroll, img.cpu()))
    return state, answers
