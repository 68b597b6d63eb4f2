#!/usr/bin/env python3
"""Kernel-alone timings of the PyTorch port's hand-written CUDA kernels on
one GPU: the kernel table of PERF.md §6.

    python3 chip_smoke.py

1. device: requires a CUDA GPU; prints the card's name and power limit as
   nvidia-smi reports them;
2. build: compiles the seven libraries (kernels/csrc/sweep_fwd.cu K1,
   sweep_bwd.cu K2, sweep_ref_fwd.cu K4, sweep_ref_bwd.cu K5,
   light_sweep.cu L, adam_clamp.cu A, warp_bilinear.cu W) and prints
   nvcc's ptxas report of each: registers per instantiation and spill
   stores;
3. times each kernel alone with CUDA events (the median of TIMED_RUNS
   launches after WARMUP), beside its plain PyTorch version and the least
   time the card could take for the same work (its bound, below):
   - K1 and K2 at the flagship: cloud_volume(256, 7) seen by the default
     camera at 1920x1080, emission, density 8; in float32 and bfloat16;
   - K1 and K2 with a light volume at config 4: the same cloud at orbit
     frame 0 and LightConfig(shadow_steps=32); float32 and bfloat16;
   - K1 and K2 at config 5's plan, where `config5.fit` runs them:
     cloud_volume(512, 7) at 1920x1080 (a 1536^2 base, 512 slices, a stage
     of 1,156 texels), emission, density 8, float32;
   - K4 and K5 at the reference preset: build_volume(VolumeConfig()),
     128^3 x 4 at 1280x720, emission, a seeded (4, 3) scroll; float32 and
     bfloat16, and with a light volume at density 8 in both; K4 and K5
     also at 256^3 x 4 and 1920x1080, float32;
   - L, the light sweep's scan, forward and adjoint at config 4's 256^3;
   - A, fit_grid's Adam step and clamp (adam_clamp.cu), at 256^3 and 512^3:
     the wrapper's call, adam_clamp_step, from one seeded state beside the
     plain version's (torch.optim.Adam's foreach step, then clamp_), each
     as many calls; bound by bytes, 28 B a voxel
     (benchmark/optimizer_roofline.py);
   - W, the screen warp's kernel pair (warp_bilinear.cu), at config 5's
     plan (512^3 at 1920x1080 from (3, 3, 3)) and config 3's (256^3 at
     1024^2): the forward with the miss select and the backward that
     splats the in-footprint pixels, each beside its plain version
     (warp_reference, splat_reference: the torch ops the warp ran before
     the kernels) and the library's F.grid_sample, all timed on the card
     alone with the host's part hidden, the kernel's calls also with it,
     the SM clock sampled meanwhile; bound by bytes, each way the two
     maps, the two output channels or cotangents and the base once;
4. holds each kernel's output at those settings to its plain version's on
   the same inputs (the last timed plain call's): base maps at rtol 2e-4,
   atol 2e-5, gradients at rtol 2e-4, atol 2e-4 of their largest (the -m
   gpu suite's tolerances), L's forward bit for bit and its adjoint to
   light_sweep_adjoint_reference; A's grid and moments after its calls bit
   for bit to the plain version's after as many; W's forward bit for bit
   (F.grid_sample's within 1e-3 of it in the footprint), its backward at
   the gradients' tolerance, and its count of splatted pixels equal to
   the footprint's; K4/K5 at 256^3 x 4 have no plain call;
5. counts launches: every timed call must move its kernel's counter by
   one, so a time is a kernel's; and one frame and one training step of
   render_image at each setting above (not 256^3 x 4), every counter
   zeroed first, must launch one forward kernel a frame, one forward and
   one backward a step, W's forward once a frame and its backward once a
   step, and with light one L forward a frame and one forward and one
   adjoint a step; and one fit_grid step at the flagship must launch K1,
   K2, A and W's forward and backward once each: the JSON's "launches"
   are those passes'.

The wider checks, at small shapes and along every path, are the -m gpu
suite's, tests/test_torch_gpu.py; this script exits at its first fail().

The second-to-last line is the kernel JSON ({"kernels": [...]}: each
kernel's times, plain version's times, bounds, shares of the bound,
registers, spills, launches on the counted passes and the largest
absolute difference from the plain version), the last {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import roofline
from volumetricrenderer_tpu_torch import (CameraConfig, LightConfig,
                                          MediumConfig, RenderConfig,
                                          VolumeConfig, build_volume,
                                          cloud_volume,
                                          light_transmittance_volume,
                                          make_camera, orbit_camera, plan_for,
                                          render_image)
from volumetricrenderer_tpu_torch.fit import fit_grid
from volumetricrenderer_tpu_torch.kernels import (adam_clamp, light_sweep,
                                                  sweep_bwd, sweep_fwd,
                                                  sweep_ref_bwd,
                                                  sweep_ref_fwd,
                                                  warp_bilinear)
from volumetricrenderer_tpu_torch.ops.lighting import light_sweep_geometry

TIMED_RUNS, WARMUP = 12, 2
RTOL, ATOL, BWD_TOL = 2e-4, 2e-5, 2e-4  # tests/test_torch_gpu.py's
PLAIN_RUNS = 3
HIDE_HOST_CYCLES = 4_000_000  # ~2 ms of the card's spin at 1980 MHz
WIDTH, HEIGHT, VOLUME = 1920, 1080, 256
CONFIG5_VOLUME = 512
BF16 = torch.bfloat16
SCROLL_SEED = 5
CONFIG4_LIGHT = LightConfig(shadow_steps=32)
# The reference medium with shadows at density 8, as the JAX package's test
# of that path takes it (tests/test_sweep_pallas_ref.py): at the preset's
# density 1 its shadows darken a pixel by less than 1e-3.
REF_SHADOW_MEDIUM = MediumConfig(density=8.0)

KERNELS = {  # name -> (module, source, line of the TPU kernel it replaces)
    "sweep_fwd": (sweep_fwd, "sweep_fwd.cu", 729),
    "sweep_bwd": (sweep_bwd, "sweep_bwd.cu", 930),
    "sweep_ref_fwd": (sweep_ref_fwd, "sweep_ref_fwd.cu", 1750),
    "sweep_ref_bwd": (sweep_ref_bwd, "sweep_ref_bwd.cu", 1914),
}
# The peaks and K1's and K2's operation counts are the benchmark's
# (benchmark/roofline.py). The 4-channel kernels', per sample in the box
# and in front of the eye (emission, an exp counted as one):
#   sweep_ref_fwd: four bilinear sums (36), the combine (4), exp's argument,
#     exp, alpha and the two carries (8)                              = 48
#   sweep_ref_bwd: the forward's 48, A~ (2), dsigma (5), its sample_scale
#     (1), the product rule on the combine's r0 * r1 and r2 + r3 (5), four
#     bilinear adjoints (40)                                          = 101
#   with a light volume, forward 14 more; backward 31 more (as K1, K2).
# Per row and column of a slice that holds such a sample: the coordinate
# (2), then per channel its scale and scroll (2) and p, floor, f, 1 - f
# (5) = 30; the light's taps are a fifth, unscaled set: 5 more.
PEAK_FLOPS, PEAK_BYTES = roofline.PEAK_FLOPS, roofline.PEAK_BYTES
FLOP_PER_SAMPLE = {**roofline.FLOP_PER_SAMPLE,
                   "sweep_ref_fwd": 48, "sweep_ref_bwd": 101,
                   "sweep_ref_fwd+light": 62, "sweep_ref_bwd+light": 132}
FLOP_PER_LINE = {**{k: roofline.FLOP_PER_LINE
                    for k in roofline.FLOP_PER_SAMPLE},
                 "sweep_ref_fwd": 30, "sweep_ref_bwd": 30,
                 "sweep_ref_fwd+light": 35, "sweep_ref_bwd+light": 35}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, count=None, runs=TIMED_RUNS, warmup=WARMUP,
            hide_host=False):
    """(median milliseconds of fn() between CUDA events after warm-up, the
    last call's result). count() is the launches of the kernel fn
    launches: every call must add one. The events bracket the host's part
    of the call too, where the card waits for it; with hide_host a spin of
    the card (HIDE_HOST_CYCLES) is queued before the first event, so the
    call's launches are queued before the card reaches them and the time
    is the card's alone."""
    before = count() if count else 0
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    if count and count() - before != runs + warmup:
        fail(f"{runs + warmup} timed calls launched the kernel "
             f"{count() - before} times")
    return statistics.median(times), out


def check(got, want, what, grad=False):
    """Holds a kernel's output (a tensor, or a tuple: the maps, or the
    gradients with the light's) to its plain version's on the same inputs:
    maps at RTOL and ATOL, gradients at BWD_TOL and BWD_TOL times their
    largest. Returns the largest absolute difference."""
    if grad and not isinstance(got, tuple):  # dG without the light's
        got, want = (got,), (want,)
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        if grad and not scale > 0.0:
            fail(f"{what}: the plain version's gradient is zero")
        rtol, atol = (BWD_TOL, BWD_TOL * scale) if grad else (RTOL, ATOL)
        e = float((g - w).abs().max())
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            fail(f"{what}: kernel and plain version differ by up to {e:.3e} "
                 f"(rtol {rtol}, atol {atol:.3e})")
        err = max(err, e)
    return err


def zero_counts():
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    for counts in (light_sweep.launches, warp_bilinear.launches):
        for kind in counts:
            counts[kind] = 0


def path_launches(label, grid, cam, cfg, medium, light=None, scroll=None):
    """The launches of one render_image frame and one training step (the
    sum of rgb^2, backward to the grid), every counter zeroed first:
    (K1, K2, K4, K5, L forward, L adjoint, W forward, W backward). Fails
    unless the frame launches one forward kernel, the step one forward and
    one backward, each of the two one W forward and the step one W
    backward, and with light one L forward a frame and one forward and one
    adjoint a step."""
    zero_counts()
    with torch.no_grad():
        render_image(grid, cam, cfg, medium, light, scroll=scroll)
    g = grid.clone().requires_grad_()
    (render_image(g, cam, cfg, medium, light, scroll=scroll)[..., :3] ** 2) \
        .sum().backward()
    torch.cuda.synchronize()
    got = tuple(mod.launches for mod, _, _ in KERNELS.values()) + (
        light_sweep.launches["forward"], light_sweep.launches["adjoint"],
        warp_bilinear.launches["forward"], warp_bilinear.launches["backward"])
    lit = (0, 0) if light is None else (2, 1)
    want = ((2, 1, 0, 0) if grid.dim() == 3 else (0, 0, 2, 1)) + lit + (2, 1)
    log(f"launches, {label} (K1, K2, K4, K5, L forward, L adjoint, W "
        f"forward, W backward): {got}")
    if got != want:
        fail(f"{label}: a frame and a step launched {got}, not {want}")
    return got


def fit_step_launches(grid, cam, cfg, medium):
    """The launches of one fit_grid step from `grid` against a zero target,
    every counter zeroed first: (K1, K2, A, W forward, W backward). Fails
    unless each is one."""
    zero_counts()
    adam_clamp.launches = 0
    target = torch.zeros((cam.height, cam.width, 3), device=grid.device)
    fit_grid(target, cam, cfg, medium, init_grid=grid, steps=1)
    torch.cuda.synchronize()
    got = (sweep_fwd.launches, sweep_bwd.launches, adam_clamp.launches,
           warp_bilinear.launches["forward"],
           warp_bilinear.launches["backward"])
    log(f"launches, one fit step at the flagship (K1, K2, A, W forward, W "
        f"backward): {got}")
    if got != (1,) * 5:
        fail(f"a fit step launched {got}, not {(1,) * 5}")
    return got


def build_all():
    """Build the seven libraries at once, one nvcc each: {name: info}."""
    mods = {name: mod for name, (mod, _, _) in KERNELS.items()}
    mods["light_sweep"] = light_sweep
    mods["adam_clamp"] = adam_clamp
    mods["warp_bilinear"] = warp_bilinear
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        jobs = {name: pool.submit(mod.build_kernel)
                for name, mod in mods.items()}
        return {name: job.result() for name, job in jobs.items()}


def ptxas_report(log_text):
    """(registers of each instantiation, the most spill-store bytes of any)
    from nvcc's -Xptxas -v output."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log_text)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                         log_text)]
    return regs, max(spills, default=0)


def inbox_samples(plan):
    """(samples, lines) of the plan: the samples in front of the eye and
    inside the box, which a sweep kernel works on when no ray ends early
    (so the bound is an upper one where rays do), and the rows plus
    columns of base pixels that hold such a sample, over the slices."""
    delta = (plan.slice_z - plan.eye01[0])[:, None]

    def inside(e, slopes):
        x = e + delta * slopes[None, :]
        return ((x >= 0.0) & (x <= 1.0)).sum(1)

    front = delta[:, 0] * plan.sign > 0.0
    rows = inside(plan.eye01[1], plan.v_grid) * front
    cols = inside(plan.eye01[2], plan.u_grid) * front
    return (int((rows * cols).sum()),
            int((rows * (cols > 0) + cols * (rows > 0)).sum()))


def bound(name, samples, lines, tensors):
    """The least time the card could take for a kernel's work: the larger
    of its float operations over the float32 peak and its bytes (each
    input read once, each output written once: `tensors`) over the memory
    rate. Returns (ms, "operations" or "bytes")."""
    flops = FLOP_PER_SAMPLE[name] * samples + FLOP_PER_LINE[name] * lines
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def seeded(shape, seed, dev, low=0.0, high=None):
    """Seeded normal (high None) or uniform [low, high) float32 values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) if high is None else rng.uniform(low, high,
                                                                shape)
    return torch.tensor(x, dtype=torch.float32, device=dev)


def single_case(grid, plan, cfg, medium, light=None):
    """K1's and K2's inputs on one plan, with the light stack where
    `light`: {"f32": (stack, light stack), "bf16": (...), "args", "flip",
    "cts"}. The light volume is built from the grid."""
    (stack, *args), flip = sweep_fwd.sweep_inputs(
        grid.permute(plan.perm), plan, cfg, medium, light)
    stack, lstack = stack.contiguous(), None
    if light is not None:
        lvol = light_transmittance_volume(grid, light, cfg, medium)
        lstack = sweep_fwd.sweep_light_stack(lvol.permute(plan.perm), plan,
                                             cfg).contiguous()
    cts = [seeded(plan.base_shape, 9 + k, grid.device) for k in range(3)]
    low = None if lstack is None else lstack.to(BF16)
    return {"f32": (stack, lstack), "bf16": (stack.to(BF16), low),
            "args": args, "flip": flip, "cts": cts}


def ref_case(grid4, plan, cfg, medium, scroll, light=None):
    """K4's and K5's inputs on one plan and a scroll, as single_case; the
    light slabs from the light volume of the grid."""
    L, *args = sweep_ref_fwd.sweep_ref_inputs(
        grid4.permute(plan.perm + (3,)), plan, cfg, medium, light, scroll)
    L, slabs = L.contiguous(), None
    if light is not None:
        lvol = light_transmittance_volume(grid4, light, cfg, medium,
                                          scroll=scroll)
        slabs = sweep_ref_fwd.sweep_ref_light_slabs(
            lvol.permute(plan.perm), plan, cfg).contiguous()
    cts = [seeded(plan.base_shape, 9 + k, grid4.device) for k in range(3)]
    low = None if slabs is None else slabs.to(BF16)
    return {"f32": (L, slabs), "bf16": (L.to(BF16), low), "args": args,
            "cts": cts}


def time_pair(case, kind, plan, ref, plain=True):
    """The forward and backward kernel (K1/K2, or K4/K5 with `ref`) on one
    case in `kind` ("f32" or "bf16"), timed, with their bounds and, where
    `plain`, their plain versions' times and outputs, which the kernels'
    are held to. Returns [(ms, plain ms, bound ms, bound by, largest
    absolute difference)] for the forward and the backward."""
    stack, light = case[kind]
    f32_stack, f32_light = case["f32"]
    args, (ct_acc, ct_t, ct_w) = case["args"], case["cts"]
    fwd_mod, bwd_mod = (sweep_ref_fwd, sweep_ref_bwd) if ref else \
        (sweep_fwd, sweep_bwd)
    if ref:
        kw = dict(emission=True, light=light)

        def fwd():
            return sweep_ref_fwd.launch_kernel(stack, *args, True, light)
        maps = fwd()

        def bwd():
            return sweep_ref_bwd.launch_kernel(stack, *args, ct_acc, ct_t,
                                               ct_w, maps[1], maps[2], **kw)
        fwd_plain = sweep_ref_fwd.sweep_ref_fwd_reference
        bwd_plain = sweep_ref_bwd.sweep_ref_bwd_reference
    else:
        flip = case["flip"]
        kw = dict(emission=True, flip=flip, address_mode="mirror",
                  light=light)

        def fwd():
            return sweep_fwd.launch_kernel(stack, *args, True, flip, False,
                                           light)
        maps = fwd()

        def bwd():
            return sweep_bwd.launch_kernel(stack, *args, ct_acc, ct_t, ct_w,
                                           maps[1], maps[2], True, flip,
                                           False, light=light)
        fwd_plain = sweep_fwd.sweep_fwd_reference
        bwd_plain = sweep_bwd.sweep_bwd_reference
    samples, lines = inbox_samples(plan)
    suffix = "" if light is None else "+light"
    name_f, name_b = fwd_mod.__name__.split(".")[-1], \
        bwd_mod.__name__.split(".")[-1]
    # Emission's backward reads ct_trans, ct_wsum, trans and wsum and
    # writes a float32 gradient of the stack's size (and of the light's).
    work_f = (stack, *args, light, maps)
    work_b = (stack, *args, light, ct_t, ct_w, maps[1], maps[2], f32_stack,
              f32_light)
    out = []
    for mod, fn, plain_fn, plain_args, name, work, grad in (
            (fwd_mod, fwd, fwd_plain, (stack, *args), name_f, work_f, False),
            (bwd_mod, bwd, bwd_plain,
             (stack, *args, ct_acc, ct_t, ct_w, maps[1], maps[2]), name_b,
             work_b, True)):
        ms, got = cuda_ms(fn, lambda mod=mod: mod.launches)
        plain_ms = err = None
        if plain:
            plain_ms, want = cuda_ms(
                lambda fn=plain_fn, a=plain_args: fn(*a, **kw),
                runs=PLAIN_RUNS, warmup=1)
            err = check(got, want, f"{name}{suffix} ({kind}) at "
                        f"{plan.base_shape}", grad)
        out.append((ms, plain_ms, *bound(name + suffix, samples, lines,
                                         work), err))
    if not ref:
        # K2's tally of one launch: its tile-slices computed, and those of
        # them read through global memory.
        sweep_bwd.tiles.reset()
        bwd()
        torch.cuda.synchronize()
        done, glob = sweep_bwd.tiles.read()
        log(f"  sweep_bwd{suffix} ({kind}) at {plan.base_shape}: {done} "
            f"tile-slices, {glob} through global memory")
    return out


def light_sweep_timings(grid, light, cfg, medium):
    """L at config 4: forward, adjoint on the forward's L and a seeded
    cotangent, the plain forward, timed; the forward held bit for bit to
    the plain forward, the adjoint to light_sweep_adjoint_reference;
    bounds by bytes (sigma read and L written once; L and dL read, the
    gradient written once)."""
    sigma = grid * medium.sample_scale
    perm, sweep = light_sweep_geometry(light, cfg, medium,
                                       tuple(sigma.shape))
    sigma = sigma.permute(perm).contiguous()
    dL = seeded(tuple(sigma.shape), 5, sigma.device)
    L = light_sweep.launch_kernel(sigma, sweep)
    torch.cuda.synchronize()

    def count(kind):
        return lambda: light_sweep.launches[kind]
    ms, got = cuda_ms(lambda: light_sweep.launch_kernel(sigma, sweep),
                      count("forward"))
    adjoint_ms, dsigma = cuda_ms(lambda: light_sweep.launch_kernel(
        L, sweep, aux=dL), count("adjoint"))
    plain_ms, want = cuda_ms(lambda: light_sweep.light_sweep_reference(
        sigma, sweep), runs=PLAIN_RUNS, warmup=1)
    if not torch.equal(got, want):
        fail("light sweep forward differs from its plain version by up to "
             f"{float((got - want).abs().max()):.3e}")
    err = check(dsigma, light_sweep.light_sweep_adjoint_reference(
        L, dL, sweep), "light sweep adjoint", grad=True)
    return {
        "shape": list(sigma.shape), "ms": ms, "adjoint_ms": adjoint_ms,
        "plain_ms": plain_ms, "max_abs_err": err,
        "bound_ms": 2 * sigma.numel() * 4 / PEAK_BYTES * 1e3,
        "bound_ms_adjoint": 3 * sigma.numel() * 4 / PEAK_BYTES * 1e3}


def adam_timings(size, dev):
    """A at size^3: adam_clamp_step (the kernel) and adam_clamp_reference
    (the plain version) timed from one seeded state (a uniform grid, a
    gradient over several decades), each WARMUP + TIMED_RUNS steps on its
    own copy; after them grid and moments must agree bit for bit. Bound by
    bytes: 28 B a voxel."""
    shape = (size,) * 3
    gen = torch.Generator(device=dev).manual_seed(size)
    grid0 = torch.rand(shape, generator=gen, device=dev)
    grad = torch.randn(shape, generator=gen, device=dev) * torch.exp(
        3.0 * torch.randn(shape, generator=gen, device=dev) - 4.0)
    runs = []
    for step in (adam_clamp.adam_clamp_step, adam_clamp.adam_clamp_reference):
        p = grid0.clone().requires_grad_()
        p.grad = grad
        opt = torch.optim.Adam([p], lr=5e-2)
        count = (lambda: adam_clamp.launches) \
            if step is adam_clamp.adam_clamp_step else None
        ms, _ = cuda_ms(lambda: step(opt, p, 0.0, 1.0), count)
        runs.append((ms, p.detach(), opt.state[p]))
    (ms, got, st), (plain_ms, want, st_want) = runs
    for a, b, what in ((got, want, "grid"),
                       (st["exp_avg"], st_want["exp_avg"], "exp_avg"),
                       (st["exp_avg_sq"], st_want["exp_avg_sq"],
                        "exp_avg_sq")):
        if not torch.equal(a, b):
            fail(f"adam_clamp at {size}^3: {what} differs from the plain "
                 f"version's by up to {float((a - b).abs().max()):.3e}")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0.0,
            "bound_ms": 28 * grid0.numel() / PEAK_BYTES * 1e3}


class SmClocks:
    """The card's SM clock in MHz, sampled by nvidia-smi every 20 ms while
    the block runs, after a spin of the card of about half a second that
    covers nvidia-smi's start: .mhz (min, median, max, samples), or None
    if nvidia-smi gave no sample."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20", "-i", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        torch.cuda._sleep(1_000_000_000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        mhz = sorted(int(x) for x in out.split() if x.isdigit())
        self.mhz = ((mhz[0], statistics.median(mhz), mhz[-1], len(mhz))
                    if mhz else None)
        return False


def warp_timings(size, width, height, dev):
    """W at a fit cell's plan (the cloud's size^3 grid at width x height
    from (3, 3, 3)), on a seeded (Hb, Wb, 2) base and seeded normal
    cotangents, miss (0, 1): the kernel forward and backward (the backward
    alone, from the saved maps, as _WarpBilinear's backward calls it),
    their plain versions and the library's warp, F.grid_sample (bilinear,
    border, align_corners=False: the same clip-then-tent taps, on a
    channel-first copy of the base made once, without the miss select;
    its backward alone from a kept graph, which splats every pixel), each
    timed on the card alone (hide_host), and the kernel's calls also with
    the host's part (call_ms, as row A's), with the SM clock sampled
    meanwhile; the forward held bit for bit to the plain version and the
    library's to within 1e-3, the gradient at the gradients' tolerance,
    the count of splatted pixels to the footprint's. Bound by bytes, each
    way: 8 B of maps and 8 B of output or cotangent a pixel, and the
    base's 8 B a texel once."""
    import torch.nn.functional as F
    cfg = RenderConfig(emission=True, quadrature="sliced")
    cam = make_camera(CameraConfig(width=width, height=height))
    plan = plan_for(cam, (size,) * 3, cfg, device=dev)
    rows, cols = plan.warp_rows01, plan.warp_cols01
    shape = tuple(plan.base_shape) + (2,)
    base = seeded(shape, 11, dev, 0.0, 1.0)
    ct = torch.randn(tuple(rows.shape) + (2,), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(12))
    miss = (0.0, 1.0)
    miss_t = torch.tensor(miss, device=dev)

    def count(kind):
        return lambda: warp_bilinear.launches[kind]

    def fwd():
        return warp_bilinear.launch_forward(base, rows, cols, miss)

    def bwd():
        return warp_bilinear.launch_backward(ct, rows, cols, shape, True)
    lib_base = base.permute(2, 0, 1)[None].contiguous().requires_grad_()
    lib_grid = torch.stack([2.0 * cols - 1.0, 2.0 * rows - 1.0], -1)[None]
    lib_ct = ct.permute(2, 0, 1)[None].contiguous()

    def lib_fwd():
        return F.grid_sample(lib_base, lib_grid, mode="bilinear",
                             padding_mode="border", align_corners=False)
    lib_out = lib_fwd()

    def lib_bwd():
        return torch.autograd.grad(lib_out, lib_base, lib_ct,
                                   retain_graph=True)[0]
    with SmClocks() as clocks:
        ms, got = cuda_ms(fwd, count("forward"), hide_host=True)
        bwd_ms, grad = cuda_ms(bwd, count("backward"), hide_host=True)
        call_ms, _ = cuda_ms(fwd, count("forward"))
        call_bwd_ms, _ = cuda_ms(bwd, count("backward"))
        with torch.no_grad():
            lib_ms, lib_got = cuda_ms(lib_fwd, hide_host=True)
        lib_bwd_ms, _ = cuda_ms(lib_bwd, hide_host=True)
    splatted, given = warp_bilinear.splat_pixels()
    plain_ms, want = cuda_ms(lambda: warp_bilinear.warp_reference(
        base, rows, cols, miss_t), runs=PLAIN_RUNS, warmup=1, hide_host=True)
    plain_bwd_ms, want_grad = cuda_ms(lambda: warp_bilinear.splat_reference(
        ct, rows, cols, shape, True), runs=PLAIN_RUNS, warmup=1,
        hide_host=True)
    if not torch.equal(got, want):
        fail(f"warp at {size}^3, {width}x{height}: the forward differs from "
             f"its plain version by up to "
             f"{float((got - want).abs().max()):.3e}")
    inr = (warp_bilinear.in01(rows) & warp_bilinear.in01(cols))[..., None]
    lib_err = float(torch.where(inr, lib_got[0].permute(1, 2, 0) - got,
                                0.0).abs().max())
    if not lib_err <= 1e-3:
        fail(f"warp at {size}^3, {width}x{height}: F.grid_sample differs "
             f"from the kernel by {lib_err:.3e} in the footprint")
    footprint = int(inr.sum())
    if (splatted, given) != (footprint, rows.numel()):
        fail(f"warp at {size}^3, {width}x{height}: splatted {splatted} of "
             f"{given} pixels, the footprint holds {footprint}")
    err = check(grad, want_grad, f"warp backward at {size}^3", grad=True)
    nbytes = rows.numel() * 16 + base.numel() * 4
    return {"plan": f"{size}^3 {width}x{height}",
            "base_shape": list(shape[:2]), "pixels": rows.numel(),
            "footprint_pixels": footprint, "ms": ms, "bwd_ms": bwd_ms,
            "call_ms": call_ms, "call_bwd_ms": call_bwd_ms,
            "plain_ms": plain_ms, "plain_bwd_ms": plain_bwd_ms,
            "library_ms": lib_ms, "library_bwd_ms": lib_bwd_ms,
            "library_max_abs_diff": lib_err, "sm_mhz": clocks.mhz,
            "max_abs_err": err, "bound_ms": nbytes / PEAK_BYTES * 1e3}


def entry(name, regs, rows, launches):
    """A kernel's JSON entry from its timings by setting and its launches
    on the counted passes."""
    _, source, line = KERNELS[name]
    n_regs, spill = regs[name]
    out = {"name": name, "route": "cuda",
           "source": f"volumetricrenderer_tpu_torch/kernels/csrc/{source}",
           "replaces": f"volumetricrenderer_tpu/kernels/sweep_pallas.py:"
                       f"{line}",
           "launches": launches, "library_ms": None,
           "registers": n_regs, "spill_bytes": spill,
           "max_abs_err": max(r[4] for r in rows.values()
                              if r[4] is not None)}
    for key, (ms, plain_ms, bound_ms, by, _) in rows.items():
        out[f"ms{key}"] = ms
        if plain_ms is not None:
            out[f"plain_ms{key}"] = plain_ms
        out[f"bound_ms{key}"] = bound_ms
        out[f"bound_by{key}"] = by
        out[f"bound_share{key}"] = bound_ms / ms
    return out


def report(gpu_line, name, rows):
    for key, (ms, plain_ms, bound_ms, by, err) in rows.items():
        log(f"[{gpu_line}] {name}{key or '_f32'}: {ms:.3f} ms against a "
            f"bound of {bound_ms:.4f} ms ({by}; share {bound_ms / ms:.4f})"
            + ("" if plain_ms is None else
               f", plain version {plain_ms:.3f} ms, largest difference "
               f"{err:.3e}"))


def main():
    t_start = time.perf_counter()
    # 1. Device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    gpu_line = smi.stdout.strip().splitlines()[0]
    log(gpu_line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, device 0: "
        f"{torch.cuda.get_device_name(0)}")
    # The plain versions' matmuls run in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 2. Build.
    regs = {}
    for name, info in build_all().items():
        log(f"build {name}: {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].strip().splitlines():
            log(f"  nvcc: {line}")
        regs[name] = ptxas_report(info["log"])
        log(f"  {name}: registers per instantiation {regs[name][0]}, most "
            f"spill-store bytes {regs[name][1]}")

    # 3. Launches: a frame and a step at each setting, counted from 0.
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    grid = cloud_volume(VOLUME, 7, device=dev)
    grid4 = build_volume(VolumeConfig(), device=dev)
    cam = make_camera(CameraConfig(width=WIDTH, height=HEIGHT))
    cam_c4 = orbit_camera(0.0, width=WIDTH, height=HEIGHT)
    cam4 = make_camera(CameraConfig())
    scroll = seeded((4, 3), SCROLL_SEED, dev, -1.5, 1.5)
    counted = [
        path_launches(label + (" bfloat16" if low else ""), g, c,
                      dataclasses.replace(cfg, dtype="bfloat16") if low
                      else cfg, m, lc, sc)
        for label, g, c, m, lc, sc in (
            ("flagship", grid, cam, medium, None, None),
            ("config 4", grid, cam_c4, medium, CONFIG4_LIGHT, None),
            ("reference", grid4, cam4, MediumConfig(), None, scroll),
            ("reference with shadows", grid4, cam4, REF_SHADOW_MEDIUM,
             CONFIG4_LIGHT, scroll))
        for low in (False, True)]
    launches = [sum(c[k] for c in counted) for k in range(8)]

    # 4. K1 and K2: the flagship, and config 4's orbit frame 0 with light.
    plan = plan_for(cam, grid.shape, cfg, device=dev)
    plan_c4 = plan_for(cam_c4, grid.shape, cfg, device=dev)
    samples, lines = inbox_samples(plan)
    log(f"flagship {VOLUME}^3 at {WIDTH}x{HEIGHT}: base {plan.base_shape}, "
        f"{plan.slice_z.shape[0]} slices, {samples} samples in the box and "
        f"in front on {lines} rows and columns; config 4 orbit frame 0: "
        f"axis {plan_c4.axis}, sign {plan_c4.sign:+d}, base "
        f"{plan_c4.base_shape}")
    flag = single_case(grid, plan, cfg, medium)
    lit = single_case(grid, plan_c4, cfg, medium, CONFIG4_LIGHT)
    rows = {"sweep_fwd": {}, "sweep_bwd": {}}
    for key, case, p, kind in (("", flag, plan, "f32"),
                               ("_light", lit, plan_c4, "f32"),
                               ("_bf16", flag, plan, "bf16"),
                               ("_bf16_light", lit, plan_c4, "bf16")):
        f, b = time_pair(case, kind, p, ref=False)
        rows["sweep_fwd"][key], rows["sweep_bwd"][key] = f, b
    del flag, lit

    # K1 and K2 at config 5's plan.
    grid5 = cloud_volume(CONFIG5_VOLUME, 7, device=dev)
    plan5 = plan_for(cam, grid5.shape, cfg, device=dev)
    log(f"config 5 {CONFIG5_VOLUME}^3 at {WIDTH}x{HEIGHT}: base "
        f"{plan5.base_shape}, {plan5.slice_z.shape[0]} slices")
    c5 = single_case(grid5, plan5, cfg, medium)
    del grid5
    f, b = time_pair(c5, "f32", plan5, ref=False)
    rows["sweep_fwd"]["_config5"], rows["sweep_bwd"]["_config5"] = f, b
    del c5
    torch.cuda.empty_cache()

    # 5. K4 and K5: the reference preset, with light at density 8, and
    # 256^3 x 4 at 1920x1080.
    plan4 = plan_for(cam4, grid4.shape, cfg, device=dev)
    medium4 = MediumConfig()
    rows["sweep_ref_fwd"], rows["sweep_ref_bwd"] = {}, {}
    ref = ref_case(grid4, plan4, cfg, medium4, scroll)
    ref_lit = ref_case(grid4, plan4, cfg, REF_SHADOW_MEDIUM, scroll,
                       CONFIG4_LIGHT)
    for key, case, kind in (("", ref, "f32"), ("_light", ref_lit, "f32"),
                            ("_bf16", ref, "bf16"),
                            ("_bf16_light", ref_lit, "bf16")):
        f, b = time_pair(case, kind, plan4, ref=True)
        rows["sweep_ref_fwd"][key], rows["sweep_ref_bwd"][key] = f, b
    del ref, ref_lit, grid4
    big4 = build_volume(VolumeConfig(size=VOLUME), device=dev)
    plan_big = plan_for(cam, big4.shape, cfg, device=dev)
    f, b = time_pair(ref_case(big4, plan_big, cfg, medium4, scroll), "f32",
                     plan_big, ref=True, plain=False)
    rows["sweep_ref_fwd"]["_256x4"], rows["sweep_ref_bwd"]["_256x4"] = f, b
    del big4

    # 6. L at config 4.
    lt = light_sweep_timings(grid, CONFIG4_LIGHT, cfg, medium)
    log(f"[{gpu_line}] light_sweep at {tuple(lt['shape'])}: forward "
        f"{lt['ms']:.3f} ms against a bound of {lt['bound_ms']:.4f} ms "
        f"(bytes; share {lt['bound_ms'] / lt['ms']:.4f}), adjoint "
        f"{lt['adjoint_ms']:.3f} ms against {lt['bound_ms_adjoint']:.4f} ms "
        f"(share {lt['bound_ms_adjoint'] / lt['adjoint_ms']:.4f}), plain "
        f"version {lt['plain_ms']:.3f} ms; forward equal to it bit for bit, "
        f"adjoint within {lt['max_abs_err']:.3e} of its plain version")

    # 7. A: a fit step's launches at the flagship, then 256^3 and 512^3.
    fit_launches = fit_step_launches(grid, cam, cfg, medium)
    del grid
    torch.cuda.empty_cache()
    adam = {}
    for size in (256, 512):
        adam[size] = adam_timings(size, dev)
        torch.cuda.empty_cache()
        a = adam[size]
        log(f"[{gpu_line}] adam_clamp at {size}^3: {a['ms']:.3f} ms against "
            f"a bound of {a['bound_ms']:.4f} ms (bytes; share "
            f"{a['bound_ms'] / a['ms']:.4f}), plain version "
            f"{a['plain_ms']:.3f} ms; grid and moments equal to it bit for "
            f"bit")

    # 8. W at config 5's and config 3's plans.
    warps = [warp_timings(512, WIDTH, HEIGHT, dev),
             warp_timings(256, 1024, 1024, dev)]
    for w in warps:
        log(f"[{gpu_line}] warp_bilinear at {w['plan']} (base "
            f"{tuple(w['base_shape'])}, {w['footprint_pixels']} of "
            f"{w['pixels']} pixels in the footprint): forward {w['ms']:.4f} "
            f"ms, backward {w['bwd_ms']:.4f} ms against a bound of "
            f"{w['bound_ms']:.4f} ms each (bytes; shares "
            f"{w['bound_ms'] / w['ms']:.4f}, "
            f"{w['bound_ms'] / w['bwd_ms']:.4f}); the calls with their host "
            f"part {w['call_ms']:.4f} and {w['call_bwd_ms']:.4f} ms; SM clock "
            f"meanwhile (min, median, max MHz; samples) {w['sm_mhz']}; plain version "
            f"{w['plain_ms']:.4f} ms and {w['plain_bwd_ms']:.4f} ms; "
            f"F.grid_sample {w['library_ms']:.4f} ms and "
            f"{w['library_bwd_ms']:.4f} ms (within "
            f"{w['library_max_abs_diff']:.3e}); forward equal to the plain "
            f"version bit for bit, gradient within {w['max_abs_err']:.3e}")

    # 9. Results.
    results = []
    for k, name in enumerate(KERNELS):
        report(gpu_line, name, rows[name])
        results.append(entry(name, regs, rows[name], launches[k]))
    n_regs, spill = regs["light_sweep"]
    results.append({
        "name": "light_sweep", "route": "cuda",
        "source": "volumetricrenderer_tpu_torch/kernels/csrc/light_sweep.cu",
        "replaces": None, "launches": launches[4] + launches[5],
        "launches_adjoint": launches[5], "max_abs_err": lt["max_abs_err"],
        "shape": lt["shape"], "ms": lt["ms"], "adjoint_ms": lt["adjoint_ms"],
        "plain_ms": lt["plain_ms"], "bound_ms": lt["bound_ms"],
        "bound_ms_adjoint": lt["bound_ms_adjoint"], "bound_by": "bytes",
        "bound_share": lt["bound_ms"] / lt["ms"],
        "bound_share_adjoint": lt["bound_ms_adjoint"] / lt["adjoint_ms"],
        "library_ms": None, "registers": n_regs, "spill_bytes": spill})
    n_regs, spill = regs["adam_clamp"]
    results.append({
        "name": "adam_clamp", "route": "cuda",
        "source": "volumetricrenderer_tpu_torch/kernels/csrc/adam_clamp.cu",
        "replaces": None, "launches": fit_launches[2], "max_abs_err": 0.0,
        **{f"{k}_{size}": v for size, a in adam.items()
           for k, v in a.items() if k != "max_abs_err"},
        **{f"bound_share_{size}": a["bound_ms"] / a["ms"]
           for size, a in adam.items()},
        "bound_by": "bytes", "library_ms": None, "registers": n_regs,
        "spill_bytes": spill})
    n_regs, spill = regs["warp_bilinear"]
    results.append({
        "name": "warp_bilinear", "route": "cuda",
        "source": "volumetricrenderer_tpu_torch/kernels/csrc/"
                  "warp_bilinear.cu",
        "replaces": None, "launches": launches[6] + launches[7],
        "launches_backward": launches[7],
        "fit_step_launches": list(fit_launches[3:]),
        "max_abs_err": max(w["max_abs_err"] for w in warps),
        "plans": warps, "bound_by": "bytes",
        "library_ms": [w["library_ms"] for w in warps],
        "registers": n_regs, "spill_bytes": spill})
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
