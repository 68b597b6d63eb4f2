"""The screen warp alone (port of tools/measure_warp.py): on the flagship
plan (256^3 at 1920x1080, emission), warp_base_to_pixels (ops/sweep.py
_WarpBilinear, whose backward is the 4-tap splat by index_add_) forward,
and forward+backward of sum(out^2), on a seeded (Hb, Wb, CH) base; the
permute of the base alone; and the splat's four index_add_ over every
pixel and over the in-footprint pixels only (splat_timings). No kernel of
the port runs here: the JAX warp is plain XLA too.

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
host_ms_fwd, host_ms_fwd_bwd, the splat's ms (splat_ms_all,
splat_ms_footprint, splat_ms_own_texels), pixels, footprint_pixels,
device, power_limit_w, timed_runs, warmup_runs, launches and
general_sweep_calls (both 0).

warp_timings, which times the warp and the warp with the finish on a
path's own base maps, is chip_smoke.py's for every training path it
measures.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import CameraConfig, RenderConfig
from ..ops.camera import make_camera
from ..ops.sweep import (_in01, _taps, finish_image, warp_base_to_pixels,
                         warp_inputs)
from ..render import plan_for
from ..utils.clock import sync
from . import (WARMUP, Counts, device_of, emit, env_int, log, median_ms,
               parse_args)

__all__ = ["workload", "warp_fwd", "warp_fwd_bwd", "permute_only",
           "warp_timings", "splat_timings", "run", "main"]

TIMED_RUNS = 12  # warp_timings' and splat_timings' default


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


def warp_timings(maps, plan, cfg, medium, light=None, indent="  ",
                 log=log):
    """Device ms of the warp alone (warp_base_to_pixels with its miss
    mask; backward from seeded normal cotangents) and of the warp with the
    per-pixel finish (finish_image; loss sum of rgb^2), forward and
    forward+backward, on these base maps; then splat_timings. Returns the
    times by name ("warp", "warp_fb", "finish", "finish_fb", "splat")."""
    maps = tuple(m.detach() for m in maps)
    base, miss = warp_inputs(maps, cfg)
    base = base.clone().requires_grad_()
    dev = base.device
    gen = torch.Generator(device=dev).manual_seed(23)
    ct = torch.randn(tuple(plan.warp_rows01.shape) + base.shape[2:],
                     generator=gen, device=dev)
    lin = tuple(m.clone().requires_grad_() for m in maps)

    def warp_fb():
        base.grad = None
        warp_base_to_pixels(base, plan, miss=miss).backward(ct)

    def finish_fb():
        for m in lin:
            m.grad = None
        (finish_image(lin, plan, cfg, medium, light)[..., :3] ** 2).sum() \
            .backward()

    def ms(fn):
        return median_ms(fn, dev, TIMED_RUNS)[0]
    t = {"warp": ms(lambda: warp_base_to_pixels(base.detach(), plan,
                                                miss=miss)),
         "warp_fb": ms(warp_fb),
         "finish": ms(lambda: finish_image(maps, plan, cfg, medium, light)),
         "finish_fb": ms(finish_fb)}
    log(f"{indent}warp alone forward        {t['warp']:.3f} ms")
    log(f"{indent}warp alone fwd+bwd        {t['warp_fb']:.3f} ms (backward "
        f"~{t['warp_fb'] - t['warp']:.3f} ms, the 4-tap splat)")
    log(f"{indent}warp + finish forward     {t['finish']:.3f} ms")
    log(f"{indent}warp + finish fwd+bwd     {t['finish_fb']:.3f} ms "
        f"(backward ~{t['finish_fb'] - t['finish']:.3f} ms)")
    t["splat"] = splat_timings(base.detach(), plan, ct, indent, log=log)
    return t


def splat_timings(base, plan, ct, indent="  ", runs=TIMED_RUNS, log=log):
    """The splat's four index_add_ alone (as _WarpBilinear's backward adds
    them, taps precomputed) over every pixel, over the in-footprint pixels
    only, and over every pixel with each out-of-footprint pixel's taps
    moved to a texel of its own. Out of the footprint the cotangent is
    zero, but the clamped taps add those zeros to the few edge texels, all
    atomics on a few addresses; the three times separate that contention
    from the count of adds. Returns {"all", "footprint", "own_texels":
    device ms, "pixels", "footprint_pixels": counts}."""
    Hb, Wb, C = base.shape
    r0, r1, _ = _taps(plan.warp_rows01, Hb)
    c0, c1, _ = _taps(plan.warp_cols01, Wb)
    idx = [(r * Wb + c).reshape(-1)
           for r, c in ((r0, c0), (r1, c0), (r0, c1), (r1, c1))]
    src = ct.reshape(-1, C)
    inr = (_in01(plan.warp_rows01) & _in01(plan.warp_cols01)).reshape(-1)
    inside = inr.nonzero()[:, 0]
    own = torch.arange(inr.numel(), device=inr.device) % (Hb * Wb)
    flat = base.new_zeros(Hb * Wb, C)

    def splat(idx, src):
        flat.zero_()
        for i in idx:
            flat.index_add_(0, i, src)
    in_idx, in_src = [i[inside] for i in idx], src[inside]
    own_idx = [torch.where(inr, i, own) for i in idx]
    t = {name: median_ms(lambda: splat(i, s), base.device, runs)[0]
         for name, i, s in (("all", idx, src), ("footprint", in_idx, in_src),
                            ("own_texels", own_idx, src))}
    t.update(pixels=inr.numel(), footprint_pixels=int(inside.numel()))
    log(f"{indent}splat's 4 index_add_      {t['all']:.3f} ms over "
        f"{t['pixels']} pixels, {t['footprint_pixels']} in the footprint; "
        f"in-footprint pixels only {t['footprint']:.3f} ms; every pixel, "
        f"the outside ones on texels of their own {t['own_texels']:.3f} ms")
    return t


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
    ct = torch.randn(tuple(plan.warp_rows01.shape) + (channels,),
                     generator=torch.Generator(device=dev).manual_seed(23),
                     device=dev)
    splat = splat_timings(base, plan, ct, "", runs)
    line.update({
        "splat_ms_all": splat["all"],
        "splat_ms_footprint": splat["footprint"],
        "splat_ms_own_texels": splat["own_texels"],
        "pixels": splat["pixels"],
        "footprint_pixels": splat["footprint_pixels"],
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
