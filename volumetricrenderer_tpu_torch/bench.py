"""North-star benchmark of the PyTorch port: prints ONE JSON line (port of
bench.py at the repository root, the JAX package's bench).

    python -m volumetricrenderer_tpu_torch.bench [--device cuda|cpu]
        [--runs 12] [--warmup 2]          (or: python3 bench_torch.py ...)

Metric (BASELINE.json): rays/s/chip, forward+backward (full voxel
gradients), cloud_volume(256, 7) at 1920x1080, emission, density 8, loss
sum(rgb^2), the plan built once and reused. vs_baseline divides by the
reference's forward-only vsync ceiling at 1280x720 (1280 * 720 * 60 =
55.3M rays/s), as bench.py does.

Phases, each with its JAX counterpart in bench.py:
  * validate_gradients (bench.py validate_gradients): the sweep's grid
    gradient against the per-ray oracle's on a small case;
  * the headline step (bench.py make_fwdbwd with use_pallas=None):
    sweep_render -> sum(rgb^2) -> backward to the grid, through K1 and K2
    on a CUDA grid; the grid's .grad is reset to None before each step.
    bench.py multiplies the grid by (1 + 0 * t) so that XLA cannot hoist
    the render out of its frame scan; eager PyTorch hoists nothing, and the
    factor would add a pass over the grid, so it is not ported;
  * the general sweep (bench.py's jnp A/B, use_pallas=False): the same step
    with use_kernels=False, fewer runs;
  * the bfloat16 stream mode (bench.py's bf16 A/B);
  * early_exit_rate (bench.py exit_rate): the share of base pixels whose
    transmittance ends at or below the early-stop threshold, by the
    general sweep, at the flagship's density and at 200.

Timing: CUDA events around each step, each step synchronized, the median
after the warm-ups, and the host clock of the same steps; on the CPU the
host clock alone (the line's "device" then says "cpu"). Sizes can be cut
for a smoke run with VOLT_BENCH_VOLUME, VOLT_BENCH_WIDTH and
VOLT_BENCH_HEIGHT, as in bench.py; the line gives the sizes it ran.

Unlike bench.py, no phase is guarded: any failure raises and the command
exits non-zero. --device defaults to "cuda": without a GPU the command
fails with torch's own error; only --device cpu runs the kernels' plain
versions on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from .config import CameraConfig, MediumConfig, RenderConfig
from .kernels import sweep_bwd, sweep_fwd
from .models.scene import cloud_volume
from .ops import sweep as ops_sweep
from .ops.camera import make_camera
from .ops.integrate import render_rays_sliced
from .render import plan_for

__all__ = ["METRIC", "REFERENCE_RAYS_PER_S", "validate_gradients",
           "early_exit_rate", "run", "main"]

METRIC = "rays/s/chip fwd+bwd at 256^3/1080p"
REFERENCE_RAYS_PER_S = 1280 * 720 * 60.0  # fwd-only vsync ceiling
SEED = 7                                   # cloud_volume's, as bench.py's
DENSE = 200.0                              # bench.py's dense medium
GENERAL_RUNS, GENERAL_WARMUP = 3, 1        # the general sweep's A/B


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _configs():
    return (RenderConfig(emission=True, quadrature="sliced"),
            MediumConfig(combine="single", density=8.0))


def validate_gradients(device):
    """bench.py validate_gradients: the sweep's grid gradient on an
    identity-warp plan (base maps = image) against the per-ray oracle's
    (ops/integrate.render_rays_sliced) on the base rays,
    cloud_volume(24, 7) at 48x32, allclose(rtol=1e-3, atol=1e-3 * scale)
    with scale = max|oracle gradient|. Returns (ok, max_abs_err, scale)."""
    cfg, medium = _configs()
    cam = make_camera(CameraConfig(width=48, height=32))
    grid = cloud_volume(24, SEED, device=device)
    plan = plan_for(cam, grid.shape, cfg, device=device)
    o, d = ops_sweep.base_rays(plan)
    g1 = grid.clone().requires_grad_()
    (ops_sweep.sweep_render(g1, dataclasses.replace(plan, identity_warp=True),
                            cfg, medium)[..., :3] ** 2).sum().backward()
    g2 = grid.clone().requires_grad_()
    (render_rays_sliced(g2, o, d, plan, cfg, medium)[..., :3] ** 2).sum() \
        .backward()
    scale = float(g2.grad.abs().max())
    ok = scale > 0.0 and bool(torch.allclose(g1.grad, g2.grad, rtol=1e-3,
                                             atol=1e-3 * scale))
    return ok, float((g1.grad - g2.grad).abs().max()), scale


def early_exit_rate(grid, plan, cfg: RenderConfig, medium: MediumConfig,
                    density: float) -> float:
    """bench.py exit_rate: the general sweep (ops/sweep._sweep_base) on
    grid.permute(plan.perm) * density with the medium's density set to 1,
    without gradients; the share of base pixels whose transmittance ends
    at or below cfg.early_stop_transmittance."""
    med = dataclasses.replace(medium, density=1.0)
    with torch.no_grad():
        maps = ops_sweep._sweep_base(
            grid.permute(plan.perm) * density, None, plan.slice_z,
            plan.v_grid, plan.u_grid, plan.seglen, plan, cfg, med, None,
            None)
        return float((maps[1] <= cfg.early_stop_transmittance)
                     .to(torch.float32).mean())


def _time_steps(step, runs: int, device):
    """(device ms per step, host ms per step) of `runs` calls of step(): on
    CUDA each step between two events and synchronized, the host clock
    around the same interval; on the CPU the host clock alone (device ms =
    host ms)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    dev_ms, host_ms = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        step()
        if cuda:
            end.record()
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return (dev_ms if cuda else host_ms), host_ms


def _per_step(count: int, runs: int):
    q = count / runs
    return int(q) if q.is_integer() else q


def _power_limit_w(device):
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def run(argv=None) -> dict:
    """Run every phase and return the JSON line's fields."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help='torch device (default "cuda": fails without '
                             'a GPU); "cpu" runs the plain PyTorch versions '
                             "of the kernels")
    parser.add_argument("--runs", type=int, default=12,
                        help="timed steps per phase (the general sweep's: "
                             f"{GENERAL_RUNS})")
    parser.add_argument("--warmup", type=int, default=2,
                        help="untimed steps before them (the general "
                             f"sweep's: {GENERAL_WARMUP})")
    args = parser.parse_args(argv)
    if args.runs < 1 or args.warmup < 0:
        parser.error("--runs must be at least 1 and --warmup at least 0")
    volume = int(os.environ.get("VOLT_BENCH_VOLUME", 256))
    width = int(os.environ.get("VOLT_BENCH_WIDTH", 1920))
    height = int(os.environ.get("VOLT_BENCH_HEIGHT", 1080))

    t_start = time.perf_counter()
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    power = _power_limit_w(device) if cuda else None
    log(f"device {kind}" + (f", power limit {power} W" if cuda else ""))

    ok, err, scale = validate_gradients(device)
    log(f"grad check: allclose={ok} max_abs_err={err:.3e} scale={scale:.3e}")

    cfg, medium = _configs()
    cam = make_camera(CameraConfig(width=width, height=height))
    t0 = time.perf_counter()
    grid = cloud_volume(volume, SEED, device=device)
    plan = plan_for(cam, grid.shape, cfg, device=device)
    if cuda:
        torch.cuda.synchronize(device)
    log(f"setup {time.perf_counter() - t0:.2f} s: {volume}^3 at "
        f"{width}x{height}, base {plan.base_shape}, slices "
        f"{plan.slice_z.shape[0]}")
    g = grid.clone().requires_grad_()

    def phase(label, step_cfg, use_kernels, runs, warmup):
        def step():
            g.grad = None
            img = ops_sweep.sweep_render(g, plan, step_cfg, medium,
                                         use_kernels=use_kernels)
            (img[..., :3] ** 2).sum().backward()
        calls0 = ops_sweep.general_calls
        for _ in range(warmup):
            step()
        # the launches of the timed steps only
        fwd0, bwd0 = sweep_fwd.launches, sweep_bwd.launches
        dev_ms, host_ms = _time_steps(step, runs, device)
        launches = {"sweep_fwd": _per_step(sweep_fwd.launches - fwd0, runs),
                    "sweep_bwd": _per_step(sweep_bwd.launches - bwd0, runs)}
        calls = ops_sweep.general_calls - calls0
        log(f"{label}: {statistics.median(dev_ms):.3f} ms/frame (host clock "
            f"{statistics.median(host_ms):.3f}), launches per step "
            f"{launches}, general sweeps {calls}")
        return dev_ms, host_ms, launches, calls

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    dev_ms, host_ms, launches, calls = phase("fwd+bwd", cfg, None, args.runs,
                                             args.warmup)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda
            else None)
    ms = statistics.median(dev_ms)
    quartiles = statistics.quantiles(dev_ms, n=4) if len(dev_ms) > 1 \
        else [ms, ms, ms]
    gen_ms, _, _, gen_calls = phase("general sweep fwd+bwd", cfg, False,
                                    GENERAL_RUNS, GENERAL_WARMUP)
    low_cfg = dataclasses.replace(cfg, dtype="bfloat16")
    low_ms, _, low_launches, low_calls = phase("bf16 fwd+bwd", low_cfg, None,
                                               args.runs, args.warmup)

    calls0 = ops_sweep.general_calls
    rate_flagship = early_exit_rate(grid, plan, cfg, medium, medium.density)
    rate_dense = early_exit_rate(grid, plan, cfg, medium, DENSE)
    rate_calls = ops_sweep.general_calls - calls0
    log(f"early-exit rates: flagship {rate_flagship}, dense {rate_dense}")

    rays_per_s = width * height / (ms * 1e-3)
    ms_general, ms_low = statistics.median(gen_ms), statistics.median(low_ms)
    return {
        "metric": METRIC,
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / REFERENCE_RAYS_PER_S,
        "volume": volume,
        "image": [width, height],
        "grad_allclose_vs_reference": ok,
        "ms_per_frame_fwd_bwd": ms,
        "ms_per_frame_fwd_bwd_quartiles": [quartiles[0], quartiles[2]],
        "host_ms_per_frame_fwd_bwd": statistics.median(host_ms),
        "kernels_vs_general": ms_general / ms,
        "ms_per_frame_general": ms_general,
        "ms_per_frame_bf16": ms_low,
        "bf16_speedup": ms / ms_low,
        "device": kind,
        "power_limit_w": power,
        "early_exit_rate_flagship": rate_flagship,
        "early_exit_rate_dense": rate_dense,
        "base_shape": list(plan.base_shape),
        "timed_runs": args.runs,
        "warmup_runs": args.warmup,
        "peak_memory_gib": peak,
        "launches_per_step": {"fwd_bwd": launches, "bf16": low_launches},
        "general_sweep_calls": {"fwd_bwd": calls, "bf16": low_calls,
                                "general": gen_calls,
                                "exit_rate": rate_calls},
        "bench_total_s": time.perf_counter() - t_start,
    }


def main(argv=None) -> int:
    """Progress lines to stderr, the JSON line last on stdout."""
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
