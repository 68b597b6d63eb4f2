"""One full sharded train step on an n-rank (data, slab) mesh (port of
__graft_entry__.dryrun_multichip(n_devices), the JAX repository's
multi-device entry point; its artifacts are MULTICHIP_r*.json).

    python -m volumetricrenderer_tpu_torch.tools.multichip
        [--ranks N] [--device cuda|cpu] [--out PATH]
    torchrun --nproc_per_node=N -m volumetricrenderer_tpu_torch.tools.multichip

--ranks defaults to every visible card (torch.cuda.device_count(); 1 with
--device cpu), one process per rank (tools.spawn_ranks). The mesh, scene
and step are the JAX function's: slab = 2 when N is even, else 1, and data
= N // slab; cloud_volume(8 * slab, 7) at 32x16 with n_slices = max(size //
2, slab) (sub-voxel slices), early stop off, density 4,
LightConfig((0.3, 0.2, 1.0), ambient=0.2, shadow_steps=8); the target is
sweep_render_sharded's frame with the light volume, then one
make_sweep_train_step step from a grid of 0.4, whose loss must be finite.
On the card every rank runs K1 and K2 with their light branch.

The line has MULTICHIP_r05.json's n_devices and ok, and adds mesh ([data,
slab]), loss, device, power_limit_w, timed_runs (0: the run times nothing
but its total_s), launches (rank 0's, the target frame and the step),
launches_per_rank, general_sweep_calls (rank 0's) and total_s. The JAX
artifact's rc, skipped and tail describe the TPU harness that ran the
function and are not ported. The function has no size to cut: its shapes
are tiny.
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from ..config import CameraConfig, LightConfig, MediumConfig, RenderConfig
from ..models.scene import cloud_volume
from ..ops.camera import make_camera
from ..ops.lighting import light_transmittance_volume
from ..parallel.mesh import make_mesh, mesh_ranks
from ..parallel.sweep_sharded import (make_sweep_train_step,
                                      sweep_render_sharded)
from ..render import plan_for
from . import Counts, device_of, emit, log, parse_args, spawn_ranks, \
    world_size

__all__ = ["mesh_shape", "workload", "dryrun", "run", "main"]

LIGHT = dict(direction=(0.3, 0.2, 1.0), ambient=0.2, shadow_steps=8)


def mesh_shape(n: int):
    """(data, slab) of the JAX function: slab 2 when n is even."""
    slab = 2 if n % 2 == 0 else 1
    return n // slab, slab


def workload(slab: int, device):
    """(grid, plan, cfg, medium, light): the whole cloud_volume(8 * slab,
    7), its plan at 32x16 with max(size // 2, slab) slices, emission with
    early stop off, density 4 and the shadowing light."""
    cfg = RenderConfig(emission=True, quadrature="sliced",
                       early_stop_transmittance=-1.0)
    medium = MediumConfig(combine="single", density=4.0)
    light = LightConfig(**LIGHT)
    size = 8 * slab
    grid = cloud_volume(size, 7, device=device)
    cam = make_camera(CameraConfig(width=32, height=16))
    plan = plan_for(cam, grid.shape, cfg, n_slices=max(size // 2, slab),
                    device=device)
    return grid, plan, cfg, medium, light


def dryrun(device) -> dict:
    """The rank body: build the mesh over the running group, render the
    target and take one sharded step. Returns rank 0's line fields (every
    rank returns its own)."""
    t0 = time.perf_counter()
    n = dist.get_world_size()
    data, slab = mesh_shape(n)
    mesh = make_mesh(data=data, slab=slab, device=device.type)
    s = mesh_ranks(mesh)[3]
    counts = Counts()
    grid, plan, cfg, medium, light = workload(slab, device)
    block = grid.chunk(slab)[s].clone()
    with torch.no_grad():
        lv = light_transmittance_volume(grid, light, cfg, medium)
        target = sweep_render_sharded(block, plan, mesh, cfg, medium, light,
                                      light_volume=lv)[..., :3]
    step, _ = make_sweep_train_step(mesh, plan, cfg, medium,
                                    torch.full_like(block, 0.4), light)
    loss = step(target)
    if not math.isfinite(loss):
        raise FloatingPointError(f"dryrun loss is not finite: {loss}")
    return {"n_devices": n, "mesh": [data, slab], "loss": loss, "ok": True,
            **device_of(device)[1], "timed_runs": 0, **counts.read_ranks(),
            "total_s": time.perf_counter() - t0}


def run(device="cuda", ranks=None):
    """The line of an n-rank dry run (None on torchrun's other ranks)."""
    dev = torch.device(device)
    world = world_size(ranks, max(torch.cuda.device_count(), 1)
                       if dev.type == "cuda" else 1)
    data, slab = mesh_shape(world)
    log(f"multichip: {world} ranks, mesh data={data} x slab={slab}")
    return spawn_ranks(dryrun, world, device)


def main(argv=None) -> int:
    args = parse_args(__doc__, argv, ranks="every visible card")
    line = run(args.device, args.ranks)
    return 0 if line is None else emit(line, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
