"""The screen warp alone (port of tools/measure_warp.py): on the flagship
plan (256^3 at 1920x1080, emission), warp_base_to_pixels (ops/sweep.py
_WarpBilinear, whose backward is the 4-tap splat) forward, and
forward+backward of sum(out^2), on a seeded (Hb, Wb, CH) base; and the
permute of the base alone. On a CUDA base the warp is the kernel pair of
kernels/warp_bilinear.py (one launch forward, one backward, which splats
only the in-footprint pixels); on the CPU, its plain version. The sweep
kernels do not run here: the JAX warp is plain XLA.

    python -m volumetricrenderer_tpu_torch.tools.measure_warp
        [--device cuda|cpu] [--out PATH]

Env: VOLT_W_FRAMES (32) and VOLT_W_ITERS (2): the JAX tool times ITERS
dispatches of FRAMES warps, so FRAMES * ITERS calls are timed here, each
on its own; VOLT_W_CH (2: the emission path warps (wsum, trans)); for a
smaller run VOLT_W_VOLUME (256), VOLT_W_WIDTH and VOLT_W_HEIGHT
(1920x1080).

The JSON line has the JAX tool's keys but these: xla_fwd and xla_fwdbwd
are ms_fwd and ms_fwd_bwd, moveaxis_only is the permute's copy
(movedim(-1, 0).contiguous(); a view alone moves no byte); band (the TPU
warp's static window) and frames (per dispatch) are left out. Added:
host_ms_fwd, host_ms_fwd_bwd, pixels, footprint_pixels (those the splat
adds), device, power_limit_w, timed_runs, warmup_runs, launches and
general_sweep_calls (both 0: the sweep kernels' and the general sweep's).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import CameraConfig, RenderConfig
from ..ops.camera import make_camera
from ..kernels.warp_bilinear import in01
from ..ops.sweep import warp_base_to_pixels
from ..render import plan_for
from ..utils.clock import sync
from . import (WARMUP, Counts, device_of, emit, env_int, log, median_ms,
               parse_args)

__all__ = ["workload", "warp_fwd", "warp_fwd_bwd", "permute_only", "run",
           "main"]


def workload(volume: int, width: int, height: int, channels: int, device):
    """(plan, base): the flagship plan of a volume^3 grid at width x height
    and a seeded uniform (Hb, Wb, channels) base."""
    cfg = RenderConfig(emission=True, quadrature="sliced")
    cam = make_camera(CameraConfig(width=width, height=height))
    plan = plan_for(cam, (volume,) * 3, cfg, device=device)
    base = torch.tensor(np.random.default_rng(0).uniform(
        size=tuple(plan.base_shape) + (channels,)), dtype=torch.float32,
        device=device)
    return plan, sync(base)


def warp_fwd(base, plan):
    """A timed function: the warp forward with its miss mask."""
    return warp_base_to_pixels(base, plan, miss=(0.0,) * base.shape[-1])


def warp_fwd_bwd(base, plan):
    """A timed function: the warp and the backward of sum(out^2) into
    base.grad (reset first; base requires grad)."""
    base.grad = None
    (warp_fwd(base, plan) ** 2).sum().backward()
    return base.grad


def permute_only(base):
    """A timed function: the channel-first copy of the base."""
    return base.movedim(-1, 0).contiguous()


def run(device="cuda") -> dict:
    runs = env_int("VOLT_W_FRAMES", 32) * env_int("VOLT_W_ITERS", 2)
    channels = env_int("VOLT_W_CH", 2)
    volume = env_int("VOLT_W_VOLUME", 256)
    width = env_int("VOLT_W_WIDTH", 1920)
    height = env_int("VOLT_W_HEIGHT", 1080)
    dev, line_device = device_of(device)
    counts = Counts()
    t0 = time.perf_counter()
    plan, base = workload(volume, width, height, channels, dev)
    log(f"plan {time.perf_counter() - t0:.2f} s, base {plan.base_shape}")
    grad_base = base.clone().requires_grad_()
    line = {"base_shape": [int(x) for x in plan.base_shape],
            "channels": channels}
    for key, fn in (("moveaxis_only", lambda: permute_only(base)),
                    ("ms_fwd", lambda: warp_fwd(base, plan)),
                    ("ms_fwd_bwd", lambda: warp_fwd_bwd(grad_base, plan))):
        ms, host_ms = median_ms(fn, dev, runs)
        line[key] = ms
        if key != "moveaxis_only":
            line["host_" + key] = host_ms
        log(f"{key}: {ms:.4f} ms (host clock {host_ms:.4f})")
    line.update({
        "pixels": plan.warp_rows01.numel(),
        "footprint_pixels": int((in01(plan.warp_rows01)
                                 & in01(plan.warp_cols01)).sum()),
        **line_device,
        "timed_runs": runs,
        "warmup_runs": WARMUP,
        **counts.read(),
    })
    return line


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    return emit(run(args.device), args.out)


if __name__ == "__main__":
    raise SystemExit(main())
