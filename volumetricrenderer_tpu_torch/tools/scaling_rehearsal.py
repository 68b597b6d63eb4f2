"""The sharded forward and train step per mesh shape (port of
tools/scaling_rehearsal.py, whose artifacts are SCALING_r*.json): the
config-5 rehearsal, cloud_volume(V, 7) at IMG x IMG, emission, density 8,
through parallel/sweep_sharded on each (data, slab) mesh in turn, one
process per rank, one card per rank on CUDA.

    python -m volumetricrenderer_tpu_torch.tools.scaling_rehearsal
        [--device cuda|cpu] [--out PATH]

Env: V (128), IMG (512), STEPS (2: timed calls of each phase),
VOLT_SR_SHAPES ("8x1,4x2,2x4,1x8", the JAX tool's shapes: DATAxSLAB, comma
separated). The shapes of one world size run in one spawn of that many
ranks (tools.spawn_ranks); on CUDA every shape needs data * slab cards,
and a shape the machine cannot hold fails the run before any rank starts
(no shape is skipped, none shrunk, none sent to gloo). `--device cpu`
runs gloo ranks on the CPU, which is what the JAX rehearsal was: a
virtual CPU mesh. Under torchrun every shape must fill its world.

Per shape, as the JAX tool: the sharded frame (sweep_render_sharded,
no_grad), its first call and STEPS timed calls; make_sweep_train_step
(Adam lr 5e-2 from a grid of 0.4, the target the unsharded frame), its
first step and STEPS timed steps, the last step's loss as final_loss. The
JAX tool's compile_s and fwd_compile_s (the XLA compiles) become the first
calls' host seconds, first_step_s and fwd_first_call_s; ms_per_step and
fwd_render_ms are rank 0's CUDA-event medians (its host clock on the CPU).
Added per shape: losses (every step's) and launches (rank 0's, the
frame's and the steps' calls); at the top device, power_limit_w,
timed_runs (STEPS, as steps_timed), launches (rank 0's of each world,
summed over the worlds), launches_per_rank (every rank's whole run, world
by world), general_sweep_calls and total_s.
"""
from __future__ import annotations

import os
import statistics
import time

import torch
import torch.distributed as dist

from ..bench import _time_steps
from ..ops.sweep import sweep_render
from ..parallel.mesh import make_mesh, mesh_ranks
from ..parallel.sweep_sharded import (make_sweep_train_step,
                                      sweep_render_sharded)
from . import (Counts, device_of, emit, env_int, launches, launches_since,
               log, parse_args, spawn_ranks, under_torchrun)
from .sharded_step import TRAIN_LR, workload

__all__ = ["SHAPES", "shapes", "shape_row", "rank_body", "run", "main"]

SHAPES = "8x1,4x2,2x4,1x8"
WHAT = ("config-5 rehearsal: the sharded frame and fwd+bwd train step per "
        "(data, slab) mesh shape, one process per rank")


def shapes(text: str):
    """[(data, slab), ...] from "DATAxSLAB,..."."""
    out = []
    for item in text.split(","):
        data, slab = item.strip().lower().split("x")
        out.append((int(data), int(slab)))
    return out


def shape_row(grid, plan, cfg, medium, target, data: int, slab: int,
              steps: int, device) -> dict:
    """One shape on the running group: the frame's and the train step's
    times, the final loss and rank 0's launches."""
    before = launches()
    mesh = make_mesh(data, slab, device=device.type)
    s = mesh_ranks(mesh)[3]
    block = grid.chunk(slab)[s].clone()

    def fwd():
        with torch.no_grad():
            return sweep_render_sharded(block, plan, mesh, cfg, medium)
    fwd_first_s = _time_steps(fwd, 1, device)[1][0] * 1e-3
    fwd_ms = _time_steps(fwd, steps, device)[0]
    g = torch.full_like(block, 0.4)
    step, _ = make_sweep_train_step(mesh, plan, cfg, medium, g,
                                    learning_rate=TRAIN_LR)
    losses = []
    first_s = _time_steps(lambda: losses.append(step(target)), 1,
                          device)[1][0] * 1e-3
    step_ms = _time_steps(lambda: losses.append(step(target)), steps,
                          device)[0]
    return {"mesh": {"data": data, "slab": slab},
            "ms_per_step": statistics.median(step_ms),
            "fwd_render_ms": statistics.median(fwd_ms),
            "first_step_s": first_s, "fwd_first_call_s": fwd_first_s,
            "final_loss": losses[-1], "losses": losses,
            "launches": launches_since(before)}


def rank_body(device, opts: dict) -> dict:
    """One rank: every shape of opts["shapes"] (all of this world's size)
    in turn. Returns the line's fields (rank 0's are printed)."""
    rank0 = dist.get_rank() == 0
    counts = Counts()
    _, line_device = device_of(device)
    grid, plan, cfg, medium = workload(opts["volume"], opts["image"],
                                       opts["image"], device)
    with torch.no_grad():
        target = sweep_render(grid, plan, cfg, medium)[..., :3].contiguous()
    rows = []
    for data, slab in opts["shapes"]:
        row = shape_row(grid, plan, cfg, medium, target, data, slab,
                        opts["steps"], device)
        rows.append(row)
        if rank0:
            log(f"  mesh {data}x{slab}: {row['ms_per_step']:.3f} ms/step, "
                f"frame {row['fwd_render_ms']:.3f} ms (first step "
                f"{row['first_step_s']:.2f} s, loss {row['final_loss']:.6g})")
    return {"base_shape": [int(x) for x in plan.base_shape], "shapes": rows,
            **line_device, **counts.read_ranks()}


def run(device="cuda"):
    """The line: every shape of VOLT_SR_SHAPES, one spawn per world size
    (None on torchrun's other ranks)."""
    opts = {"volume": env_int("V", 128), "image": env_int("IMG", 512),
            "steps": env_int("STEPS", 2)}
    todo = shapes(os.environ.get("VOLT_SR_SHAPES", SHAPES))
    worlds = sorted({d * s for d, s in todo})
    dev_type = torch.device(device).type
    if under_torchrun():
        have = int(os.environ["WORLD_SIZE"])
        if worlds != [have]:
            raise ValueError(f"mesh shapes {todo} under torchrun's world of "
                             f"{have}")
    elif dev_type == "cuda" and worlds[-1] > torch.cuda.device_count():
        raise RuntimeError(
            f"mesh shapes {todo} need up to {worlds[-1]} CUDA devices, one "
            f"per rank; {torch.cuda.device_count()} visible")
    log(f"rehearsal: {opts['volume']}^3 grid, {opts['image']}x"
        f"{opts['image']}, shapes {todo}")
    t_all = time.perf_counter()
    by_shape, results = {}, []
    for world in worlds:
        mine = [sh for sh in todo if sh[0] * sh[1] == world]
        res = spawn_ranks(rank_body, world, device, {**opts, "shapes": mine})
        if res is None:
            return None
        by_shape.update(zip(mine, res["shapes"]))
        results.append(res)
    first = results[0]
    return {"what": WHAT, "volume": opts["volume"], "image": opts["image"],
            "base_shape": first["base_shape"], "steps_timed": opts["steps"],
            "timed_runs": opts["steps"],
            "shapes": [by_shape[sh] for sh in todo],
            "total_s": time.perf_counter() - t_all,
            "device": first["device"],
            "power_limit_w": first["power_limit_w"],
            "launches": {k: sum(r["launches"][k] for r in results)
                         for k in first["launches"]},
            "launches_per_rank": [x for r in results
                                  for x in r["launches_per_rank"]],
            "general_sweep_calls": sum(r["general_sweep_calls"]
                                       for r in results)}


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    line = run(args.device)
    return 0 if line is None else emit(line, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
