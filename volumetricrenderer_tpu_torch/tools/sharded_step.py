"""The sharded frame and train step beside the unsharded ones (port of
tools/sharded_tpu.py, whose artifacts are SHARDED_TPU_r*.json): the
flagship scene (cloud_volume(256, 7), 1920x1080, emission, density 8)
through parallel/sweep_sharded on a (1, N) mesh, one card per rank.

    python -m volumetricrenderer_tpu_torch.tools.sharded_step
        [--ranks N] [--device cuda|cpu] [--out PATH]
    torchrun --nproc_per_node=N -m volumetricrenderer_tpu_torch.tools.sharded_step

--ranks defaults to 1, the JAX tool's 1x1 mesh (tools.spawn_ranks: one
process per rank). Each rank holds its z block of the grid; the six
variants are timed in turns (ITERS rounds of one call each, after WARMUP
calls of each), as the JAX tool interleaves them:

    base_fwd_{un,}sharded      K1's base maps: ops/sweep's kernel sweep of
                               the whole grid, or the sweep stage of
                               sweep_render_sharded up to its slab
                               composite (the block's stack, local_sweep,
                               _composite_slabs), no warp
    full_fwd_{un,}sharded      the frame: sweep_render, sweep_render_sharded
    full_fwdbwd_{un,}sharded   the frame, sum(rgb^2), backward to the grid
                               (or to the rank's block)

then fwd_max_abs_diff (the sharded frame's rows against the same rows of
the unsharded frame, the largest over the ranks: 0.0 at one rank), six
steps of make_sweep_train_step (Adam lr 5e-2 from a grid of 0.4, the target
the unsharded frame) and, with VOLT_SH_512, the 512^3 sweep at 128 slices
sharded, forward+backward, from cloud_volume(512, 7) built directly (the
JAX tool's upsampled 256^3 fallback for a compile that ran out of memory
is not ported: an error raises).

Env: VOLT_SH_VOLUME (256), VOLT_SH_WIDTH and VOLT_SH_HEIGHT (1920x1080),
VOLT_SH_ITERS (4: timed rounds), VOLT_SH_512 (1; 0 leaves that phase out).
The TPU devices are dropped: the null-dispatch calibration, the lax.scan of
VOLT_SH_FRAMES frames in one dispatch, the g * (1 + 0 * t) guard against
hoisting, and with them null_dispatch_ms, frames_per_dispatch, the Mosaic
windows and the 512 phase's compile_s (in its place the first call's
seconds, sharded_512_first_call_s).

The line has the JAX artifact's other keys (ms_per_frame by variant, the
three *_sharded_vs_unsharded ratios, fwd_max_abs_diff, train_step_losses,
train_loss_ratio, train_6steps_s, sharded_512_128slices_fwdbwd_ms,
sharded_512_total_s, total_s; ms are rank 0's CUDA-event medians, on
the CPU its host clock) and adds host_ms_per_frame, launches_per_variant
(rank 0's timed calls of each variant), launches_train (the six steps),
launches_512 (the 512 phase's calls), launches (rank 0's whole run) and
launches_per_rank (every rank's), general_sweep_calls, device,
power_limit_w, ranks, timed_runs and warmup_runs.
"""
from __future__ import annotations

import statistics
import time

import torch
import torch.distributed as dist

from ..bench import _time_steps
from ..kernels import sweep_fwd
from ..ops.sweep import sweep_render
from ..parallel.mesh import SLAB_AXIS, all_gather, all_to_all, make_mesh, \
    mesh_ranks
from ..parallel.sweep_sharded import (_block_stacks, _composite_slabs,
                                      frame_rows, local_plan, local_sweep,
                                      make_sweep_train_step,
                                      sweep_render_sharded)
from ..render import plan_for
from . import (WARMUP, Counts, device_of, emit, env_int, launches,
               launches_since, log, parse_args, scale512, spawn_ranks,
               world_size)

__all__ = ["VARIANTS", "TRAIN_STEPS", "TRAIN_LR", "settings", "workload",
           "base_sharded", "variants", "rank_body", "run", "main"]

VARIANTS = ("base_fwd_unsharded", "base_fwd_sharded", "full_fwd_unsharded",
            "full_fwd_sharded", "full_fwdbwd_unsharded",
            "full_fwdbwd_sharded")
TRAIN_STEPS, TRAIN_LR = 6, 5e-2


def settings() -> dict:
    """The run's sizes from the environment (module docstring), and the
    512 phase's volume and slices."""
    return {"volume": env_int("VOLT_SH_VOLUME", 256),
            "width": env_int("VOLT_SH_WIDTH", 1920),
            "height": env_int("VOLT_SH_HEIGHT", 1080),
            "iters": env_int("VOLT_SH_ITERS", 4),
            "do512": bool(env_int("VOLT_SH_512", 1)),
            "volume_512": 512, "slices_512": 128}


def workload(volume: int, width: int, height: int, device, n_slices=None):
    """(grid, plan, cfg, medium): scale512's scene (cloud_volume(volume,
    7) whole, the default camera at width x height, emission, density 8)
    and its plan of n_slices slices (None: the voxel planes)."""
    grid, cam, cfg, medium = scale512.workload(volume, width, height, device)
    plan = plan_for(cam, grid.shape, cfg, n_slices=n_slices, device=device)
    return grid, plan, cfg, medium


def base_sharded(block, plan, mesh, cfg, medium):
    """The sweep stage of sweep_render_sharded up to its slab composite,
    no warp: this rank's stack (its own layers, regrouped by an all-to-all
    when the sweep axis is not z, or lerped from the gathered volume for
    sub-voxel slices), local_sweep (K1 on a CUDA block) and the butterfly
    composite over "slab". Returns the (acc, trans, wsum, hit) base maps of
    this rank's base rows, composited over the slabs."""
    n_data, d, n_slab, s = mesh_ranks(mesh)
    group = mesh.get_group(SLAB_AXIS)
    lp = local_plan(plan, n_slab, s, n_data, d)
    extent = (block.shape[0] * n_slab, *block.shape[1:])[plan.perm[0]]
    gperm = k_block = None
    if extent == plan.slice_z.shape[0]:
        k_block = block.permute(plan.perm)
        if plan.perm[0] != 0:
            k_block = all_to_all(k_block, group, 0, 1)
    else:
        gperm = all_gather(block, group).permute(plan.perm)
    stack, _, _ = _block_stacks(gperm, k_block, None, lp, plan, cfg, medium,
                                None, s)
    maps = local_sweep(stack, None, None, lp, plan, cfg, medium, None, None)
    return _composite_slabs(maps, n_slab, plan.sign, s, group)


def _frame_loss(img):
    return (img[..., :3] ** 2).sum()


def _fwdbwd(x, render):
    """A timed function: render(x), sum(rgb^2), backward into x.grad (reset
    first). Returns the loss."""
    def call():
        x.grad = None
        loss = _frame_loss(render(x))
        loss.backward()
        return loss.detach()
    return call


def variants(grid, block, plan, mesh, cfg, medium) -> dict:
    """name -> a function of no argument returning the variant's value (the
    JAX tool's scalar: sum(trans) + sum(wsum) of the base maps, sum(rgb^2)
    of the frame); the forward+backward variants leave the gradient in
    grid.grad or block.grad (reset before each call). grid and block
    require grad."""
    def base_unsharded():
        with torch.no_grad():
            m = sweep_fwd.sweep_base(grid.permute(plan.perm), plan, cfg,
                                     medium)
        return m[1].sum() + m[2].sum()

    def base_shard():
        with torch.no_grad():
            m = base_sharded(block, plan, mesh, cfg, medium)
        return m[1].sum() + m[2].sum()

    def full_unsharded():
        with torch.no_grad():
            return _frame_loss(sweep_render(grid, plan, cfg, medium))

    def full_sharded():
        with torch.no_grad():
            return _frame_loss(sweep_render_sharded(block, plan, mesh, cfg,
                                                    medium))

    return dict(zip(VARIANTS, (
        base_unsharded, base_shard, full_unsharded, full_sharded,
        _fwdbwd(grid, lambda g: sweep_render(g, plan, cfg, medium)),
        _fwdbwd(block, lambda b: sweep_render_sharded(b, plan, mesh, cfg,
                                                      medium)))))


def _block_of(grid, mesh):
    n_slab, s = mesh_ranks(mesh)[2:]
    return grid.chunk(n_slab)[s].clone()


def _time_turns(fns: dict, device, iters: int):
    """Each function WARMUP times, then `iters` rounds of one timed call of
    each in turn. Returns ({name: [device ms]}, {name: [host ms]},
    {name: launches of its timed calls})."""
    for fn in fns.values():
        for _ in range(WARMUP):
            fn()
    dev_ms = {k: [] for k in fns}
    host_ms = {k: [] for k in fns}
    counts = {k: dict.fromkeys(launches(), 0) for k in fns}
    for _ in range(iters):
        for name, fn in fns.items():
            before = launches()
            d, h = _time_steps(fn, 1, device)
            n = launches_since(before)
            dev_ms[name] += d
            host_ms[name] += h
            counts[name] = {k: counts[name][k] + n[k] for k in n}
    return dev_ms, host_ms, counts


def _max_over_ranks(x: float, device) -> float:
    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def rank_body(device, opts: dict) -> dict:
    """One rank of the run: the variants, the frames' difference, the
    train steps and the 512 phase. Returns the line's fields (rank 0's
    are printed)."""
    t_all = time.perf_counter()
    n = dist.get_world_size()
    mesh = make_mesh(1, n, device=device.type)
    rank0 = dist.get_rank() == 0
    say = log if rank0 else (lambda msg: None)
    counts = Counts()
    _, line_device = device_of(device)
    grid, plan, cfg, medium = workload(opts["volume"], opts["width"],
                                       opts["height"], device)
    say(f"sharded_step: {n} ranks, mesh 1x{n}, {opts['volume']}^3 at "
        f"{opts['width']}x{opts['height']}, base {plan.base_shape}, "
        f"{plan.slice_z.shape[0]} slices")
    block = _block_of(grid, mesh).requires_grad_()
    g = grid.clone().requires_grad_()
    fns = variants(g, block, plan, mesh, cfg, medium)
    dev_ms, host_ms, per_variant = _time_turns(fns, device, opts["iters"])
    ms = {k: statistics.median(v) for k, v in dev_ms.items()}
    res = {"volume": opts["volume"], "width": opts["width"],
           "height": opts["height"], "iters": opts["iters"], "ranks": n,
           "mesh": f"data=1 x slab={n}",
           "base_shape": [int(x) for x in plan.base_shape],
           "ms_per_frame": ms,
           "host_ms_per_frame": {k: statistics.median(v)
                                 for k, v in host_ms.items()},
           "launches_per_variant": per_variant}
    for name in VARIANTS:
        say(f"{name}: {ms[name]:.3f} ms a frame, launches "
            f"{per_variant[name]}")
    for stage in ("base_fwd", "full_fwd", "full_fwdbwd"):
        res[f"{stage}_sharded_vs_unsharded"] = \
            ms[f"{stage}_sharded"] / ms[f"{stage}_unsharded"]

    with torch.no_grad():
        img_un = sweep_render(grid, plan, cfg, medium)
        img_sh = sweep_render_sharded(block, plan, mesh, cfg, medium)
    h0, h1, _ = frame_rows(plan, mesh)
    res["fwd_max_abs_diff"] = _max_over_ranks(
        float((img_sh - img_un[h0:h1]).abs().max()), device)
    say(f"fwd_max_abs_diff {res['fwd_max_abs_diff']}")

    target = img_un[..., :3].contiguous()
    g0 = torch.full_like(block.detach(), 0.4)
    step, _ = make_sweep_train_step(mesh, plan, cfg, medium, g0,
                                    learning_rate=TRAIN_LR)
    before = launches()
    t0 = time.perf_counter()
    losses = [step(target) for _ in range(TRAIN_STEPS)]
    res["train_6steps_s"] = time.perf_counter() - t0
    res["launches_train"] = launches_since(before)
    res["train_step_losses"] = losses
    res["train_loss_ratio"] = losses[-1] / losses[0]
    say(f"train losses {losses}")
    del fns, g, block, grid, g0, step, img_un, img_sh, target

    if opts["do512"]:
        t0 = time.perf_counter()
        before = launches()
        grid5, plan5, cfg, medium = workload(
            opts["volume_512"], opts["width"], opts["height"], device,
            n_slices=opts["slices_512"])
        block5 = _block_of(grid5, mesh).requires_grad_()
        del grid5
        call = _fwdbwd(block5, lambda b: sweep_render_sharded(
            b, plan5, mesh, cfg, medium))
        first = _time_steps(call, 1, device)[1][0] * 1e-3
        dev5, _ = _time_steps(call, max(opts["iters"] - 1, 2), device)
        res["sharded_512_128slices_fwdbwd_ms"] = statistics.median(dev5)
        res["sharded_512_first_call_s"] = first
        res["sharded_512_total_s"] = time.perf_counter() - t0
        res["launches_512"] = launches_since(before)
        say(f"512^3 at 128 slices, sharded fwd+bwd: "
            f"{res['sharded_512_128slices_fwdbwd_ms']:.3f} ms")
    res.update({"total_s": time.perf_counter() - t_all, **line_device,
                "timed_runs": opts["iters"], "warmup_runs": WARMUP,
                **counts.read_ranks()})
    return res


def run(device="cuda", ranks=None):
    """The line of a run on `ranks` ranks (None on torchrun's other
    ranks)."""
    return spawn_ranks(rank_body, world_size(ranks, 1), device, settings())


def main(argv=None) -> int:
    args = parse_args(__doc__, argv, ranks="1, the JAX tool's 1x1 mesh")
    line = run(args.device, args.ranks)
    return 0 if line is None else emit(line, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
