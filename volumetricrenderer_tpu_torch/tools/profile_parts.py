"""The flagship forward+backward step timed stage by stage (port of
tools/profile_parts.py): cloud_volume(V, 7) at W x H, emission, density 8
(sharded_step.workload, scale512's scene), one process, each stage its own
timed function.

    python -m volumetricrenderer_tpu_torch.tools.profile_parts
        [--device cuda|cpu] [--out PATH]

    base_fwd           K1: kernels/sweep_fwd.sweep_base on the permuted
                       grid, no_grad; value: the sum of the four base maps
    base_fwd_general   the general sweep (ops/sweep._sweep_base, the JAX
                       tool's base_fwd_jnp), no_grad, the same value
    full_fwd           sweep_render, no_grad; value: sum(rgb^2)
    warp_fwd           finish_image of K1's base maps, no_grad; sum(rgb^2)
    warp_fwdbwd        the same, backward to the base maps
    base_fwdbwd        K1, the sum of the four maps, backward (K2) to the
                       permuted grid
    full_fwdbwd        sweep_render, sum(rgb^2), backward to the grid

Env: V (256), W (1920), H (1080), K (2) and I (2): the JAX tool scanned K
frames in each of I timed dispatches, so each stage here is I * K calls
timed one by one (CUDA events, the median; on the CPU the host clock),
after WARMUP untimed calls; VOLT_PP_GENERAL=0 leaves base_fwd_general out
(a loop of matmuls per slice, seconds a call at the flagship). The TPU
devices are dropped: the null dispatch, the lax.scan of K frames, the g *
(1 + 0 * t) guard against hoisting, and the "wa_all build" stage, which
timed the TPU kernels' one-hot row matrices (the port's kernels take taps
from shared memory and build no such matrix).

The line: ms_per_frame and host_ms_per_frame by stage, launches_per_stage
(the timed calls'), base_shape, slices, volume, width, height, and the
runners' device, power_limit_w, timed_runs, warmup_runs, launches (the
timed calls of all stages) and general_sweep_calls (the whole run).
"""
from __future__ import annotations

import statistics
import time

import torch

from ..kernels import sweep_fwd
from ..ops.sweep import _sweep_base, finish_image, sweep_render
from . import (WARMUP, Counts, device_of, emit, env_int, launches, log,
               parse_args, time_calls)
from .sharded_step import workload

__all__ = ["STAGES", "stages", "run", "main"]

STAGES = ("base_fwd", "base_fwd_general", "full_fwd", "warp_fwd",
          "warp_fwdbwd", "base_fwdbwd", "full_fwdbwd")


def _rgb2(img):
    return (img[..., :3] ** 2).sum()


def stages(grid, plan, cfg, medium) -> dict:
    """name -> a function of no argument returning the stage's value; each
    forward+backward stage leaves its gradient in the .grad of the input
    it returns beside the value: (value, input). The inputs are made here:
    the grid permuted to the sweep axis (dense, as K1 reads it) and K1's
    base maps of it."""
    gperm = grid.permute(plan.perm).contiguous()
    with torch.no_grad():
        maps0 = tuple(m.contiguous() for m in
                      sweep_fwd.sweep_base(gperm, plan, cfg, medium))
    gp = gperm.clone().requires_grad_()
    g = grid.clone().requires_grad_()
    maps = tuple(m.clone().requires_grad_() for m in maps0)

    def base(x):
        return sum(m.sum() for m in sweep_fwd.sweep_base(x, plan, cfg,
                                                         medium))

    def base_general():
        with torch.no_grad():
            m = _sweep_base(gperm, None, plan.slice_z, plan.v_grid,
                            plan.u_grid, plan.seglen, plan, cfg, medium,
                            None, None)
        return sum(x.sum() for x in m)

    def backward(value_of, x):
        def call():
            if isinstance(x, tuple):
                for t in x:
                    t.grad = None
            else:
                x.grad = None
            value = value_of(x)
            value.backward()
            return value.detach(), x
        return call

    def no_grad(fn, x):
        def call():
            with torch.no_grad():
                return fn(x)
        return call

    def warp(m):
        return _rgb2(finish_image(m, plan, cfg, medium))

    def full(x):
        return _rgb2(sweep_render(x, plan, cfg, medium))

    return {"base_fwd": no_grad(base, gperm),
            "base_fwd_general": base_general,
            "full_fwd": no_grad(full, grid),
            "warp_fwd": no_grad(warp, maps0),
            "warp_fwdbwd": backward(warp, maps),
            "base_fwdbwd": backward(base, gp),
            "full_fwdbwd": backward(full, g)}


def run(device="cuda") -> dict:
    volume, width, height = env_int("V", 256), env_int("W", 1920), \
        env_int("H", 1080)
    runs = env_int("K", 2) * env_int("I", 2)
    general = bool(env_int("VOLT_PP_GENERAL", 1))
    t_all = time.perf_counter()
    dev, line_device = device_of(device)
    whole = Counts()
    grid, plan, cfg, medium = workload(volume, width, height, dev)
    log(f"base {plan.base_shape} slices {plan.slice_z.shape[0]}")
    fns = stages(grid, plan, cfg, medium)
    if not general:
        del fns["base_fwd_general"]
    ms, host, per_stage = {}, {}, {}
    timed = dict.fromkeys(launches(), 0)
    for name, fn in fns.items():
        dev_ms, host_ms, n = time_calls(fn, dev, runs)
        ms[name] = statistics.median(dev_ms)
        host[name] = statistics.median(host_ms)
        per_stage[name] = n
        timed = {k: timed[k] + n[k] for k in timed}
        log(f"{name:18s} {ms[name]:9.3f} ms/frame (host clock "
            f"{host[name]:.3f}), launches {n}")
    return {"volume": volume, "width": width, "height": height,
            "base_shape": [int(x) for x in plan.base_shape],
            "slices": int(plan.slice_z.shape[0]),
            "ms_per_frame": ms, "host_ms_per_frame": host,
            "launches_per_stage": per_stage,
            "total_s": time.perf_counter() - t_all, **line_device,
            "timed_runs": runs, "warmup_runs": WARMUP, "launches": timed,
            "general_sweep_calls": whole.read()["general_sweep_calls"]}


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    return emit(run(args.device), args.out)


if __name__ == "__main__":
    raise SystemExit(main())
