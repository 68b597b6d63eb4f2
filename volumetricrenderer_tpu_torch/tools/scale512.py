"""Config 5's volume on one GPU (port of tools/scale512.py): a 512^3 FBM
cloud (cloud_volume(512, 7), a 512 MiB float32 grid) at 1920x1080, the
forward frame and the forward+backward step (loss sum of rgb^2, gradient to
the grid) at 512, 256 and 128 slices: K1 per frame, K1 and K2 per step.

    python -m volumetricrenderer_tpu_torch.tools.scale512
        [--device cuda|cpu] [--out PATH]

Env: VOLT_S_FRAMES (8: timed calls per phase, after WARMUP),
VOLT_S_SLICES ("512,256,128"); for a smaller run VOLT_S_VOLUME (512),
VOLT_S_WIDTH and VOLT_S_HEIGHT (1920x1080). The plan of S slices is
plan_for(..., n_slices=None if S == volume else S), as in the JAX tool;
each plan is built and freed in turn.

The JAX tool falls back to an upsampled 256^3 cloud when its remote
compiler fails; that fallback is not ported: a failure raises.

The JSON line has the JAX artifact's keys (SCALE512_r*.json) but these TPU
ones: row_window, dispatch_overhead_ms, frames_per_dispatch and each
slice count's compile_s. Its top-level ms_per_frame_fwd,
ms_per_frame_fwd_bwd and mrays_per_s_fwd_bwd are those of the first of
VOLT_S_SLICES (512 by default). Added per slice count: host_ms_fwd,
host_ms_fwd_bwd, plan_s and the launches of each timed phase; at the top
peak_memory_gib (CUDA), device, power_limit_w, timed_runs, warmup_runs,
launches (all timed phases) and general_sweep_calls (the whole run).
"""
from __future__ import annotations

import os
import statistics
import time

import torch

from ..config import CameraConfig, MediumConfig, RenderConfig
from ..models.scene import cloud_volume
from ..ops.camera import make_camera
from ..ops.sweep import sweep_render
from ..render import plan_for
from ..utils.clock import sync
from . import (WARMUP, Counts, device_of, emit, env_int, launches, log,
               parse_args, time_calls)

__all__ = ["REFERENCE_RAYS_PER_S", "SLICE_NOTE", "workload", "plan_at",
           "fwd", "fwd_bwd", "run", "main"]

REFERENCE_RAYS_PER_S = 1280 * 720 * 60.0  # the reference's vsync ceiling
SLICE_NOTE = (
    "slices=512 integrates at voxel-plane density (4x the reference "
    "quadrature); the reference caps its march at 128 steps for ANY volume "
    "size (frag.glsl:30, stepSize=4/128), so slices=128 is reference step "
    "parity and slices=256 is 2x it (the flagship 256^3 bench density)")


def workload(volume: int, width: int, height: int, device):
    """(grid, camera, cfg, medium): cloud_volume(volume, 7) and the default
    camera at width x height, emission, density 8."""
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    cam = make_camera(CameraConfig(width=width, height=height))
    return sync(cloud_volume(volume, 7, device=device)), cam, cfg, medium


def plan_at(cam, grid, cfg, slices: int):
    """The plan at `slices` slices (the voxel planes when slices equals
    the grid's depth)."""
    return plan_for(cam, grid.shape, cfg,
                    n_slices=None if slices == grid.shape[0] else slices,
                    device=grid.device)


def fwd(grid, plan, cfg, medium):
    """A timed function: the forward frame, without gradients."""
    with torch.no_grad():
        return sweep_render(grid, plan, cfg, medium)


def fwd_bwd(grid, plan, cfg, medium):
    """A timed function: sweep_render -> sum(rgb^2) -> backward into
    grid.grad (reset first; grid requires grad). Returns the frame."""
    grid.grad = None
    img = sweep_render(grid, plan, cfg, medium)
    (img[..., :3] ** 2).sum().backward()
    return img.detach()


def run(device="cuda") -> dict:
    runs = env_int("VOLT_S_FRAMES", 8)
    slices = [int(x) for x in
              os.environ.get("VOLT_S_SLICES", "512,256,128").split(",")]
    volume = env_int("VOLT_S_VOLUME", 512)
    width = env_int("VOLT_S_WIDTH", 1920)
    height = env_int("VOLT_S_HEIGHT", 1080)
    t_all = time.perf_counter()
    dev, line_device = device_of(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    whole = Counts()
    t0 = time.perf_counter()
    grid, cam, cfg, medium = workload(volume, width, height, dev)
    log(f"cloud_volume({volume}, 7) in {time.perf_counter() - t0:.2f} s")
    g = grid.clone().requires_grad_()
    rays = width * height
    by_slices, timed = {}, dict.fromkeys(launches(), 0)
    base_shape = None
    for S in slices:
        t0 = time.perf_counter()
        plan = plan_at(cam, grid, cfg, S)
        sync(plan.warp_rows01)
        plan_s = time.perf_counter() - t0
        base_shape = base_shape or [int(x) for x in plan.base_shape]
        row = {"plan_s": plan_s}
        for key, fn, x in (("fwd", fwd, grid), ("fwd_bwd", fwd_bwd, g)):
            dev_ms, host_ms, n = time_calls(
                lambda: fn(x, plan, cfg, medium), dev, runs)
            row[f"ms_per_frame_{key}"] = statistics.median(dev_ms)
            row[f"host_ms_{key}"] = statistics.median(host_ms)
            row[f"launches_{key}"] = n
            timed = {k: timed[k] + n[k] for k in timed}
            log(f"{volume}^3/{S} {key}: {row[f'ms_per_frame_{key}']:.3f} ms "
                f"a frame (host clock {row[f'host_ms_{key}']:.3f}), plan "
                f"{plan_s:.2f} s, timed launches {n}")
        fb = row["ms_per_frame_fwd_bwd"]
        row["mrays_per_s_fwd_bwd"] = rays / fb * 1e-3
        row["vs_reference_ceiling"] = rays / fb * 1e3 / REFERENCE_RAYS_PER_S
        by_slices[str(S)] = row
        del plan
    first = by_slices[str(slices[0])]
    return {
        "config": "config5 volume, single chip",
        "volume": volume, "width": width, "height": height,
        "grid_bytes_mb": grid.numel() * grid.element_size() / 2 ** 20,
        "base_shape": base_shape,
        "slice_note": SLICE_NOTE,
        "by_slices": by_slices,
        "ms_per_frame_fwd": first["ms_per_frame_fwd"],
        "ms_per_frame_fwd_bwd": first["ms_per_frame_fwd_bwd"],
        "mrays_per_s_fwd_bwd": first["mrays_per_s_fwd_bwd"],
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if cuda else None),
        "total_s": time.perf_counter() - t_all,
        **line_device,
        "timed_runs": runs,
        "warmup_runs": WARMUP,
        "launches": timed,
        "general_sweep_calls": whole.read()["general_sweep_calls"],
    }


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    return emit(run(args.device), args.out)


if __name__ == "__main__":
    raise SystemExit(main())
