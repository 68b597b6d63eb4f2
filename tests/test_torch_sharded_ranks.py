"""Ranks of a gloo process group on the CPU for tests/test_torch_sharded.py
and tests/test_torch_runners.py (this module holds no test of its own).

`run_world(world, jobs, tmp)` spawns `world` processes once, each joins one
gloo group (init_method file:// in tmp, so pytest-xdist workers share no
port), runs every job on the port's parallel/ modules and returns rank 0's
results: {job name: dict of numpy arrays and floats}. A job is (case name,
keyword arguments); the cases build their own (data, slab) mesh. This file
imports no JAX: the ranks run the port only (the plain versions of the
kernels), and the tests compare their results with the JAX package in the
parent process."""
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from volumetricrenderer_tpu_torch.ops.sweep import SweepPlan
from volumetricrenderer_tpu_torch.parallel import bootstrap
from volumetricrenderer_tpu_torch.parallel.mesh import make_mesh, mesh_ranks
from volumetricrenderer_tpu_torch.parallel.render_sharded import (
    make_sharded_renderer, make_train_step, shard_rays)
from volumetricrenderer_tpu_torch.parallel.sweep_sharded import (
    frame_rows, make_sweep_train_step, sweep_render_sharded)


def torch_plan(arrays):
    """A SweepPlan from the numpy arrays and fields of a (JAX) plan."""
    t = {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v
         for k, v in arrays.items()}
    return SweepPlan(**t)


def _gather_rows(mesh, rows, h0, extra=None):
    """Every rank's (h0, rows, extra) on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (mesh_ranks(mesh), h0, rows, extra))
    return out


def _assemble(parts, n_slab):
    """The whole frame from the slab-rank-0 parts, their grid blocks in
    slab order, and the largest difference between ranks that should hold
    equal values (frame rows across slab ranks, grid gradients across data
    ranks)."""
    rows = {}
    grads = {}
    spread = 0.0
    for (_, _, _, s), h0, img, grad in parts:
        if h0 in rows:
            spread = max(spread, float(np.abs(rows[h0] - img).max()))
        else:
            rows[h0] = img
        if grad is not None:
            if s in grads:
                spread = max(spread, float(np.abs(grads[s] - grad).max()))
            else:
                grads[s] = grad
    img = np.concatenate([rows[h] for h in sorted(rows)])
    grad = (np.concatenate([grads[s] for s in range(n_slab)])
            if grads else None)
    return img, grad, spread


def case_frame(shape, grid, plan, cfg, medium, light=None, scroll=None,
               lvol=None, grad=True):
    """sweep_render_sharded on mesh `shape`: the whole frame, the whole
    grid gradient of sum(rgb^2) (and the light volume's), the spread."""
    n_data, n_slab = shape
    mesh = make_mesh(n_data, n_slab, device="cpu")
    s = mesh_ranks(mesh)[3]
    depth = grid.shape[0] // n_slab
    g = torch.from_numpy(grid[s * depth:(s + 1) * depth].copy())
    g.requires_grad_(grad)
    lv = None
    if lvol is not None:
        lv = torch.from_numpy(lvol.copy()).requires_grad_(grad)
    tplan = torch_plan(plan)
    img = sweep_render_sharded(
        g, tplan, mesh, cfg, medium, light,
        scroll=None if scroll is None else torch.from_numpy(scroll),
        light_volume=lv)
    if grad:
        (img[..., :3] ** 2).sum().backward()
    h0, _, holders = frame_rows(tplan, mesh)
    parts = _gather_rows(mesh, img.detach().numpy(), h0,
                         g.grad.numpy() if grad else None)
    out = {}
    out["image"], out["grad"], out["spread"] = _assemble(parts, n_slab)
    out["holders"] = holders
    if lv is not None and grad:
        out["light_grad"] = lv.grad.numpy()
        lgs = [None] * dist.get_world_size()
        dist.all_gather_object(lgs, out["light_grad"])
        out["spread"] = max([out["spread"]] + [float(np.abs(x - lgs[0]).max())
                                               for x in lgs])
    return out


def case_train(shape, plan, cfg, medium, target, init=0.4, light=None,
               steps=8, lr=5e-2, depth=16):
    """make_sweep_train_step on mesh `shape` from a constant grid: the
    losses, the whole grid gradient of the first step (before any update)
    and the final grid, with the largest difference between data ranks of
    each."""
    n_data, n_slab = shape
    mesh = make_mesh(n_data, n_slab, device="cpu")
    tplan = torch_plan(plan)
    g = torch.full((depth // n_slab, depth, depth), init)
    step, _ = make_sweep_train_step(mesh, tplan, cfg, medium, g, light,
                                    learning_rate=lr)
    t = torch.from_numpy(target)
    losses = [step(t)]
    parts = _gather_rows(mesh, np.zeros((1, 1)), 0, g.grad.numpy())
    _, grad1, grad_spread = _assemble(parts, n_slab)
    losses += [step(t) for _ in range(steps - 1)]
    parts = _gather_rows(mesh, np.zeros((1, 1)), 0, g.detach().numpy())
    _, grid, spread = _assemble(parts, n_slab)
    return {"losses": np.array(losses), "grad1": grad1, "grid": grid,
            "spread": spread, "grad_spread": grad_spread}


def case_rays(shape, grid, origins, directions, cfg, medium, light,
              spatial=False, target=None, steps=0, lr=1e-2):
    """render_sharded's renderer (and, with steps, its train step) on mesh
    `shape`: the whole frame (padding removed), the losses, the grid."""
    n_data, n_slab = shape
    mesh = make_mesh(n_data, n_slab, device="cpu")
    _, d, _, s = mesh_ranks(mesh)
    o, dr, pad = shard_rays(torch.from_numpy(origins),
                            torch.from_numpy(directions), mesh)
    g = torch.from_numpy(grid.copy())
    if spatial:
        depth = grid.shape[0] // n_slab
        g = g[s * depth:(s + 1) * depth].clone()
    img = make_sharded_renderer(mesh, cfg, medium, light, spatial)(
        g, o, dr, torch.zeros((1, 3)))
    parts = _gather_rows(mesh, img.detach().numpy(), d)
    frame, _, spread = _assemble(parts, n_slab)
    out = {"image": frame[:frame.shape[0] - pad], "pad": pad,
           "spread": spread}
    if steps:
        t = torch.from_numpy(target)
        rows = o.shape[0]
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])[
            d * rows:(d + 1) * rows]
        g = torch.full_like(g, 0.2)
        step, _ = make_train_step(mesh, cfg, medium, g, light,
                                  learning_rate=lr, spatial_grid=spatial)
        out["losses"] = np.array([step(o, dr, t) for _ in range(steps)])
        parts = _gather_rows(mesh, np.zeros((1, 1)), 0, g.detach().numpy())
        out["grid"] = _assemble(parts, n_slab)[1]
    return out


def case_bootstrap():
    """process_summary inside a running group."""
    return bootstrap.process_summary()


CASES = {"frame": case_frame, "train": case_train, "rays": case_rays,
         "bootstrap": case_bootstrap}


def _rank(rank, world, init_file, out_file, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        results = {}
        for name, (case, kwargs) in jobs.items():
            results[name] = CASES[case](**kwargs)
        if rank == 0:
            with open(out_file, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def runner_jobs(device, jobs):
    """The rank body of tests/test_torch_runners.py's worlds (through
    tools.spawn_ranks): every job, {name: (runner module, function,
    arguments)}, each function called as fn(device, *arguments) on the
    running group; returns {name: result}."""
    import importlib
    out = {}
    for name, (module, fn, args) in jobs.items():
        mod = importlib.import_module(
            f"volumetricrenderer_tpu_torch.tools.{module}")
        out[name] = getattr(mod, fn)(device, *args)
    return out


def fail_on_rank_1(device):
    """A rank body whose rank 1 raises while rank 0 waits at a barrier."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()
    return "rank 0 passed the barrier"


def pid(device):
    """A rank body that returns its process id."""
    return os.getpid()


def run_world(world, jobs, tmp):
    """Run `jobs` on `world` spawned gloo ranks; rank 0's results."""
    init_file = os.path.join(str(tmp), f"init-{world}")
    out_file = os.path.join(str(tmp), f"out-{world}.pkl")
    mp.spawn(_rank, args=(world, init_file, out_file, jobs), nprocs=world,
             join=True)
    with open(out_file, "rb") as f:
        return pickle.load(f)


def plan_arrays(jplan):
    """The fields of a JAX plan that the port's SweepPlan has, as numpy
    arrays and plain values (picklable for the ranks)."""
    names = [f.name for f in dataclasses.fields(SweepPlan)]
    out = {}
    for n in names:
        v = getattr(jplan, n)
        out[n] = (tuple(v) if isinstance(v, tuple) else
                  v if isinstance(v, (int, bool)) else np.array(v))
    return out

