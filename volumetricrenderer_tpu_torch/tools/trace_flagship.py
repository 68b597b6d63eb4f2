"""A per-op device profile of the flagship step (port of
tools/trace_flagship.py): torch.profiler over K forward+backward steps of
cloud_volume(256, 7) at 1920x1080 (sweep_render, loss sum of rgb^2,
backward to the grid; K1 and K2 once a step), the device's kernels summed
by name: the top 15 by device time, each with its count and ms per step,
and the device's busy and idle share of the wall clock per step.

    python -m volumetricrenderer_tpu_torch.tools.trace_flagship
        [--device cuda|cpu] [--out PATH]

Env: V (256), W (1920), H (1080), K (8), as the JAX tool's (those of
tools/profile_parts.py); VOLT_TRACE_FWD_ONLY=1 profiles the forward frame
alone (K1 only).

The JAX tool writes the trace under a directory and prints its device
line; here the aggregate is the JSON line ("top_ops"), and no trace file
is written. On the CPU there is no device line: the ops are the host's,
by self CPU time, and busy_ms_per_step and idle_share are null.
Keys: volume, width, height, steps, fwd_only, base_shape, slices,
wall_ms_per_step, busy_ms_per_step, idle_share, ops_clock, top_ops,
device, power_limit_w, timed_runs, warmup_runs, launches (the profiled
steps) and general_sweep_calls (the whole run).

profile_fwdbwd is chip_smoke.py's profile of every training step it
measures.
"""
from __future__ import annotations

import collections
import os
import time

import torch

from ..config import CameraConfig, MediumConfig, RenderConfig
from ..models.scene import cloud_volume
from ..ops.camera import make_camera
from ..ops.sweep import sweep_render
from ..render import plan_for
from ..utils.clock import sync
from . import (Counts, device_of, emit, env_int, launches, launches_since,
               log, parse_args)

__all__ = ["TOP", "workload", "step_fn", "profile_steps", "profile_fwdbwd",
           "run", "main"]

TOP = 15  # ops listed


def workload(volume: int, width: int, height: int, device):
    """(grid requiring grad, plan, cfg, medium): the flagship's."""
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    cam = make_camera(CameraConfig(width=width, height=height))
    grid = cloud_volume(volume, 7, device=device)
    plan = plan_for(cam, grid.shape, cfg, device=device)
    return sync(grid).requires_grad_(), plan, cfg, medium


def step_fn(grid, plan, cfg, medium, fwd_only=False):
    """The profiled function: one flagship step, forward+backward (the
    grid's .grad reset first) or, with fwd_only, the frame alone."""
    def step():
        if fwd_only:
            with torch.no_grad():
                return sweep_render(grid, plan, cfg, medium)
        grid.grad = None
        (sweep_render(grid, plan, cfg, medium)[..., :3] ** 2).sum() \
            .backward()
    return step


def profile_steps(step, device, n: int = 3):
    """torch.profiler over n calls of step() after one untimed call.
    Returns {"wall_ms", "busy_ms": per step (busy None on the CPU), "ops":
    [(name, count, total ms)] by time, largest first, "names": every
    event's name, "table": key_averages' table, "clock": "device" or
    "host", "launches": the kernel launches of the n calls}. On CUDA the
    ops are the device's kernels and busy_ms their sum; on the CPU the
    host ops by self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    step()
    if cuda:
        torch.cuda.synchronize(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    before = launches()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        if cuda:
            torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    counted = launches_since(before)
    events = prof.events()
    agg = collections.defaultdict(lambda: [0, 0.0])
    if cuda:
        for e in events:
            if e.device_type == DeviceType.CUDA:
                agg[e.name][0] += 1
                agg[e.name][1] += e.time_range.elapsed_us() * 1e-3
        busy_ms = sum(t for _, t in agg.values()) / n
        sort = "self_device_time_total"
    else:
        for a in prof.key_averages():
            agg[a.key] = [a.count, a.self_cpu_time_total * 1e-3]
        busy_ms, sort = None, "self_cpu_time_total"
    ops = sorted(((name, c, t) for name, (c, t) in agg.items()),
                 key=lambda op: -op[2])
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "ops": ops,
            "names": {e.name for e in events},
            "table": prof.key_averages().table(sort_by=sort, row_limit=25),
            "clock": "device" if cuda else "host", "launches": counted}


def profile_fwdbwd(step, out_dir, name="chip_smoke_profile.txt", n=3,
                   log=log):
    """profile_steps(step, "cuda", n), its table written to out_dir/name and
    logged with the device's busy and idle share per step. Returns the
    profile."""
    prof = profile_steps(step, "cuda", n)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write(prof["table"] + "\n")
    log(prof["table"])
    busy, wall = prof["busy_ms"], prof["wall_ms"]
    log(f"profile: device busy {busy:.3f} ms per step of {wall:.3f} ms wall "
        f"(idle share {1 - busy / wall:.3f}); table in {path}")
    return prof


def run(device="cuda") -> dict:
    volume, width, height = (env_int("V", 256), env_int("W", 1920),
                             env_int("H", 1080))
    k = env_int("K", 8)
    fwd_only = bool(env_int("VOLT_TRACE_FWD_ONLY", 0))
    dev, line_device = device_of(device)
    whole = Counts()
    grid, plan, cfg, medium = workload(volume, width, height, dev)
    log(f"base {plan.base_shape} slices {plan.slice_z.shape[0]}")
    prof = profile_steps(step_fn(grid, plan, cfg, medium, fwd_only), dev, k)
    busy, wall = prof["busy_ms"], prof["wall_ms"]
    top = [{"name": name, "count": c, "ms_per_step": t / k}
           for name, c, t in prof["ops"][:TOP]]
    log(f"--- {prof['clock']} ops, ms per step (wall {wall:.3f} ms"
        + (f", busy {busy:.3f}" if busy is not None else "") + ") ---")
    for op in top:
        log(f"{op['ms_per_step']:9.3f} ms/step  x{op['count']:6d}  "
            f"{op['name'][:100]}")
    return {
        "volume": volume, "width": width, "height": height,
        "steps": k, "fwd_only": fwd_only,
        "base_shape": [int(x) for x in plan.base_shape],
        "slices": int(plan.slice_z.shape[0]),
        "wall_ms_per_step": wall,
        "busy_ms_per_step": busy,
        "idle_share": None if busy is None else 1.0 - busy / wall,
        "ops_clock": prof["clock"],
        "top_ops": top,
        **line_device,
        "timed_runs": k,
        "warmup_runs": 1,
        "launches": prof["launches"],
        "general_sweep_calls": whole.read()["general_sweep_calls"],
    }


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    return emit(run(args.device), args.out)


if __name__ == "__main__":
    raise SystemExit(main())
