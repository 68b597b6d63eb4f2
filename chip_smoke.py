#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: the forward render
(serving) and the forward+backward render and fit (training).

    python3 chip_smoke.py [--out DIR]

Drives volumetricrenderer_tpu_torch only (no JAX) through its main paths:

1. device: requires torch.cuda.is_available(); prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles both hand-written sweep kernels (kernels/csrc/
   sweep_fwd.cu and sweep_bwd.cu, one nvcc each, started together) from the
   checkout and prints the build times and ptxas reports;
3. the forward kernel against its plain PyTorch version at small shapes:
   five eyes (three sweep axes, both signs) x emission/absorption x
   mirror/clamp/wrap, plus sub-voxel slicing (n_slices != depth);
4. the backward kernel against its plain version in the same cases plus
   the density-500 early-stop case, on seeded normal cotangents; in each
   case the plain version is also held to autograd of the forward's;
5. bench.py's gradient check through the kernels: the sweep's grid
   gradient on an identity-warp plan against the per-ray oracle's,
   cloud_volume(24, 7) at 48x32;
6. serving: cloud_volume(256, 7) rendered through render_image at
   1920x1080 for the default camera and three orbit cameras, with the
   launch counts set to 0 before those four renders and read after; each
   frame must be finite with alpha in [0, 1], and its base maps and image
   must match the plain version's;
7. training, with the counts set to 0 before and read after: one flagship
   forward+backward step (sum of rgb^2, gradient to the grid, each kernel
   launched exactly once), its dG held against the plain backward on the
   same cotangents; then BASELINE config 3 at spec, fit_grid of a 256^3
   grid to the 1024x1024 render of the baked cloud+smoke scene for 5
   steps (the loss must fall, no step skipped, 5 launches of each kernel);
8. timing with CUDA events (median after warm-up): both kernels and their
   plain versions, the warp and finish forward and backward, render_image,
   and the flagship forward+backward step; the fit step on the host clock;
   a torch.profiler table of the forward+backward step with the device's
   busy and idle share;
9. prints a JSON line of kernel results, then the last line
   {"ok": true, "device": {...}}.

Any failure raises, so the exit code is non-zero and no result is printed.
The default frame and the profile table are saved in --out (default: the
package's _build/ directory, which git ignores).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from volumetricrenderer_tpu_torch import (CameraConfig, LightConfig,
                                          MediumConfig, RenderConfig,
                                          cloud_volume, make_camera,
                                          orbit_camera, plan_for,
                                          render_image)
from volumetricrenderer_tpu_torch.fit import fit_grid
from volumetricrenderer_tpu_torch.kernels import sweep_bwd, sweep_fwd
from volumetricrenderer_tpu_torch.models.scene import bake_scene, \
    config3_scene
from volumetricrenderer_tpu_torch.ops.integrate import render_rays_sliced
from volumetricrenderer_tpu_torch.ops.sweep import base_rays, finish_image, \
    sweep_render
from volumetricrenderer_tpu_torch.utils.image import write_png

# Forward: kernel and plain version take the same per-pixel, front-to-back
# slice order and the same separately rounded tap coordinates (the kernel
# builds with --fmad=false), so they differ only in the order of the
# bilinear tap sum (four products in the kernel, two banded matmuls in the
# plain version) and in expf's last bit, compounded over at most 256
# slices: ~1e-6 on maps in [0, 1]. The tolerance is the JAX tests' own
# (tests/test_sweep_pallas.py), which holds the TPU kernels to the jnp
# sweep.
RTOL, ATOL = 2e-4, 2e-5
# Backward: the kernel adds its taps with atomics, in another order on
# every run, so dG is held to rtol=2e-4, atol=2e-4 * max|dG|, and 5e-4 in
# the early-stop case: tests/test_sweep_pallas.py's tolerances for K2.
BWD_TOL, BWD_TOL_GATE = 2e-4, 5e-4

SMALL_EYES = [  # (eye, sweep axis, sign) as in tests/test_sweep_pallas.py
    ((3.0, 0.4, 0.3), 0, -1),
    ((-3.0, 0.4, 0.3), 0, 1),
    ((0.3, 3.0, 0.4), 1, -1),
    ((0.4, 0.3, 3.0), 2, -1),
    ((0.4, 0.3, -3.0), 2, 1),
]
# Orbit angles at the default elevation: sweep axes x, y and x again with
# the opposite sign (the default camera sweeps z).
ORBIT_T = (0.0, 0.5 * math.pi, math.pi)
WIDTH, HEIGHT, VOLUME = 1920, 1080, 256
FIT_SIZE, FIT_IMAGE, FIT_STEPS, FIT_LR = 256, 1024, 5, 5e-2
TIMED_RUNS = 12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def max_err(a, b):
    return float((a - b).abs().max())


def check_close(got, want, what):
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"{what}: kernel and plain version disagree, max abs err "
             f"{max_err(got, want):.3e} (rtol={RTOL}, atol={ATOL})")
    return max_err(got, want)


def check_grad(got, want, what, tol=BWD_TOL):
    """Holds a gradient to rtol=tol, atol=tol * max|want|; returns the max
    abs error and max|want|."""
    scale = float(want.abs().max())
    if not scale > 0.0:
        fail(f"{what}: the reference gradient is zero")
    if not torch.allclose(got, want, rtol=tol, atol=tol * scale):
        fail(f"{what}: gradients disagree, max abs err "
             f"{max_err(got, want):.3e} at max|dG| {scale:.3e} "
             f"(rtol={tol}, atol={tol}*max|dG|)")
    return max_err(got, want), scale


def cuda_ms(fn, runs=TIMED_RUNS, warmup=2):
    """Median milliseconds of fn() between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def maps_both(grid, plan, cfg, medium):
    """Base maps from the kernel and from the plain version, on the same
    inputs. The kernel launch here is a comparison, not the main path."""
    gperm = grid.permute(plan.perm)
    got = sweep_fwd.sweep_base(gperm, plan, cfg, medium)
    torch.cuda.synchronize()
    inputs, flip = sweep_fwd.sweep_inputs(gperm, plan, cfg, medium)
    want = sweep_fwd.sweep_fwd_reference(
        *inputs, emission=cfg.emission, flip=flip,
        address_mode=cfg.address_mode)
    return got, want


def bwd_both(grid, plan, cfg, medium, rng):
    """dG from the backward kernel and from its plain version on the same
    inputs (the forward kernel's trans and wsum maps, seeded normal
    cotangents), and the plain version against autograd of the forward's
    plain version. Returns (kernel, plain, plain on its own forward,
    autograd)."""
    (stack, *args), flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm),
                                                  plan, cfg, medium)
    stack = stack.contiguous()
    wrap = cfg.address_mode == "wrap"
    kw = dict(emission=cfg.emission, flip=flip,
              address_mode=cfg.address_mode)
    maps = sweep_fwd.launch_kernel(stack, *args, cfg.emission, flip, wrap)
    cts = [torch.tensor(rng.normal(size=plan.base_shape),
                        dtype=torch.float32, device=grid.device)
           for _ in range(3)]
    got = sweep_bwd.launch_kernel(stack, *args, *cts, maps[1], maps[2],
                                  cfg.emission, flip, wrap)
    torch.cuda.synchronize()
    want = sweep_bwd.sweep_bwd_reference(stack, *args, *cts, maps[1],
                                         maps[2], **kw)
    st = stack.detach().clone().requires_grad_()
    fmaps = sweep_fwd.sweep_fwd_reference(st, *args, **kw)
    loss = sum((m * c).sum() for m, c in zip(fmaps[:3], cts))
    auto, = torch.autograd.grad(loss, st)
    own = sweep_bwd.sweep_bwd_reference(st.detach(), *args, *cts,
                                        fmaps[1].detach(), fmaps[2].detach(),
                                        **kw)
    return got, want, own, auto


class StepClock:
    """A fit_grid metrics sink that records the host clock at each write
    (fit_grid writes after step 0 and after the last step)."""

    def __init__(self):
        self.marks = []

    def write(self, step, **metrics):
        self.marks.append((step, time.perf_counter()))


def counts():
    return sweep_fwd.launches, sweep_bwd.launches


def reset_counts():
    sweep_fwd.launches = 0
    sweep_bwd.launches = 0


def build_both():
    """Build the two kernels' libraries at once: one nvcc each."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        jobs = {name: pool.submit(mod.build_kernel)
                for name, mod in (("sweep_fwd", sweep_fwd),
                                  ("sweep_bwd", sweep_bwd))}
        return {name: job.result() for name, job in jobs.items()}


def profile_fwdbwd(step, out_dir, n=3):
    """torch.profiler over n forward+backward steps: prints the device
    time by kernel and the device's busy share of the wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA) * 1e-3 / n
    path = os.path.join(out_dir, "chip_smoke_profile.txt")
    with open(path, "w") as f:
        f.write(table + "\n")
    log(table)
    log(f"profile: device busy {busy_ms:.3f} ms per step of {wall_ms:.3f} "
        f"ms wall (idle share {1 - busy_ms / wall_ms:.3f}); table in {path}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None,
                        help="directory for the flagship PNG and profile")
    args = parser.parse_args(argv)

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
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}")
    # The plain versions' matmuls run in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out_dir = args.out or os.path.join(
        os.path.dirname(os.path.abspath(sweep_fwd.__file__)), os.pardir,
        "_build")
    os.makedirs(out_dir, exist_ok=True)

    # 2. Build.
    for name, info in build_both().items():
        log(f"build {name}: {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].strip().splitlines():
            log(f"  nvcc: {line}")

    # 3. Forward kernel against the plain version at small shapes.
    errs = []
    rng = np.random.default_rng(0)
    small = torch.tensor(rng.uniform(0.2, 1.0, (16, 16, 16)),
                         dtype=torch.float32, device=dev)
    medium = MediumConfig(combine="single", density=8.0)
    cases = [(eye, ax, sg, em, mode, None, 8.0)
             for eye, ax, sg in SMALL_EYES
             for em in (True, False)
             for mode in ("mirror", "clamp", "wrap")]
    cases += [(SMALL_EYES[0][0], 0, -1, em, "mirror", 24, 8.0)
              for em in (True, False)]
    small_plans = []
    for eye, axis, sign, emission, mode, n_slices, _ in cases:
        cfg = RenderConfig(emission=emission, quadrature="sliced",
                           address_mode=mode)
        cam = make_camera(CameraConfig(eye=eye, width=96, height=64))
        plan = plan_for(cam, small.shape, cfg, n_slices=n_slices, device=dev)
        if (plan.axis, plan.sign) != (axis, sign):
            fail(f"eye {eye}: plan sweeps axis {plan.axis} sign {plan.sign},"
                 f" expected {axis} {sign}")
        small_plans.append((cfg, plan))
        got, want = maps_both(small, plan, cfg, medium)
        e = max(check_close(g, w, f"small eye={eye} emission={emission} "
                            f"{mode} n_slices={n_slices} {name}")
                for g, w, name in zip(got, want,
                                      ("acc", "trans", "wsum", "hit")))
        errs.append(e)
        log(f"fwd small eye={eye} axis={axis} sign={sign:+d} "
            f"emission={emission} {mode} n_slices={n_slices}: "
            f"max abs err {e:.3e}")

    # 4. Backward kernel against the plain version at small shapes, and
    # the plain version against autograd of the forward's.
    bwd_errs = []
    bwd_cases = list(zip(cases, small_plans))
    gate_cfg = RenderConfig(emission=True, quadrature="sliced")
    bwd_cases.append(((SMALL_EYES[0][0], 0, -1, True, "mirror", None, 500.0),
                      (gate_cfg, small_plans[0][1])))
    brng = np.random.default_rng(9)
    for (eye, _, _, emission, mode, n_slices, density), (cfg, plan) \
            in bwd_cases:
        med = MediumConfig(combine="single", density=density)
        tol = BWD_TOL_GATE if density > 100.0 else BWD_TOL
        what = (f"bwd small eye={eye} emission={emission} {mode} "
                f"n_slices={n_slices} density={density}")
        got, want, own, auto = bwd_both(small, plan, cfg, med, brng)
        e, scale = check_grad(got, want, what, tol)
        e_auto, _ = check_grad(own, auto, what + " (plain vs autograd)", tol)
        bwd_errs.append(e)
        log(f"{what}: max abs err {e:.3e} (max|dG| {scale:.3e}); plain vs "
            f"autograd {e_auto:.3e}")

    # 5. bench.py's gradient check, through the kernels.
    cfg = RenderConfig(emission=True, quadrature="sliced")
    cam = make_camera(CameraConfig(width=48, height=32))
    g24 = cloud_volume(24, 7, device=dev)
    plan = plan_for(cam, g24.shape, cfg, device=dev)
    o, d = base_rays(plan)
    g1 = g24.clone().requires_grad_()
    (sweep_render(g1, dataclasses.replace(plan, identity_warp=True), cfg,
                  medium)[..., :3] ** 2).sum().backward()
    g2 = g24.clone().requires_grad_()
    (render_rays_sliced(g2, o, d, plan, cfg, medium)[..., :3] ** 2).sum() \
        .backward()
    scale = float(g2.grad.abs().max())
    ok = scale > 0.0 and bool(torch.allclose(g1.grad, g2.grad, rtol=1e-3,
                                             atol=1e-3 * scale))
    log(f"grad check: allclose={ok} max_abs_err="
        f"{max_err(g1.grad, g2.grad):.3e} scale={scale:.3e}")
    if not ok:
        fail("bench gradient check: the kernels' grid gradient disagrees "
             "with the per-ray oracle's")

    # 6. Serving: the flagship forward, a few requests through
    # render_image.
    t0 = time.perf_counter()
    grid = cloud_volume(VOLUME, 7, device=dev)
    torch.cuda.synchronize()
    log(f"cloud_volume({VOLUME}, 7): {time.perf_counter() - t0:.2f} s")
    cams = [("default", make_camera(CameraConfig(width=WIDTH,
                                                 height=HEIGHT)))]
    cams += [(f"orbit t={t:.4f}", orbit_camera(t, width=WIDTH,
                                               height=HEIGHT))
             for t in ORBIT_T]
    frames = []
    reset_counts()
    for name, cam in cams:
        before = sweep_fwd.launches
        plan = plan_for(cam, grid.shape, cfg, device=dev)
        img = render_image(grid, cam, cfg, medium, plan=plan)
        torch.cuda.synchronize()
        if sweep_fwd.launches != before + 1:
            fail(f"{name}: render_image launched the sweep kernel "
                 f"{sweep_fwd.launches - before} times, expected 1")
        frames.append((name, plan, img))
    serve_launches = counts()
    log(f"serving path: {len(frames)} frames, launches (fwd, bwd) "
        f"{serve_launches}")
    if serve_launches != (len(frames), 0):
        fail(f"serving path launched {serve_launches}, expected "
             f"({len(frames)}, 0)")

    for name, plan, img in frames:
        if tuple(img.shape) != (HEIGHT, WIDTH, 4):
            fail(f"{name}: image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            fail(f"{name}: non-finite pixels")
        alpha = img[..., 3]
        if float(alpha.min()) < 0.0 or float(alpha.max()) > 1.0:
            fail(f"{name}: alpha outside [0, 1]: "
                 f"[{float(alpha.min())}, {float(alpha.max())}]")
        if float(alpha.max()) <= 0.0:
            fail(f"{name}: empty frame (the cloud is in view)")
        got, want = maps_both(grid, plan, cfg, medium)
        e = max(check_close(g, w, f"{name} {n}")
                for g, w, n in zip(got, want,
                                   ("acc", "trans", "wsum", "hit")))
        e_img = check_close(img, finish_image(want, plan, cfg, medium),
                            f"{name} image")
        errs += [e, e_img]
        log(f"{name}: axis={plan.axis} sign={plan.sign:+d} base "
            f"{plan.base_shape} slices {plan.slice_z.shape[0]}; maps max "
            f"abs err {e:.3e}, image {e_img:.3e}, alpha mean "
            f"{float(alpha.mean()):.4f}")

    png = write_png(os.path.join(out_dir, "chip_smoke_flagship.png"),
                    frames[0][2])
    log(f"saved {os.path.normpath(png)}")

    # 7. Training: one flagship forward+backward step, then the config-3
    # fit at spec.
    _, plan, _ = frames[0]
    cam = cams[0][1]
    seen = []  # (arguments, dG) of each backward kernel launch
    launch_bwd = sweep_bwd.launch_kernel

    def spy(*a):
        dG = launch_bwd(*a)
        seen.append((a, dG))
        return dG

    reset_counts()
    sweep_bwd.launch_kernel = spy
    g = grid.clone().requires_grad_()
    img = render_image(g, cam, cfg, medium, plan=plan)
    loss = (img[..., :3] ** 2).sum()
    loss.backward()
    torch.cuda.synchronize()
    sweep_bwd.launch_kernel = launch_bwd
    step_launches = counts()
    if step_launches != (1, 1) or len(seen) != 1:
        fail(f"flagship forward+backward launched (fwd, bwd) "
             f"{step_launches}, expected (1, 1)")
    bwd_args, dG = seen[0]
    if not bool(torch.isfinite(g.grad).all()) or \
            not float(g.grad.abs().max()) > 0.0:
        fail("flagship grid gradient is not finite and nonzero")
    if not torch.equal(g.grad.permute(plan.perm), dG):
        fail("flagship grid gradient is not the backward kernel's dG")
    want = sweep_bwd.sweep_bwd_reference(
        *bwd_args[:11], emission=bwd_args[11], flip=bwd_args[12],
        address_mode=cfg.address_mode)
    e_flag, scale_flag = check_grad(dG, want, "flagship dG")
    bwd_errs.append(e_flag)
    log(f"flagship fwd+bwd: loss {loss.item():.6e}, launches (fwd, bwd) "
        f"{step_launches}, dG max abs err {e_flag:.3e} at max|dG| "
        f"{scale_flag:.3e}, grad nonzero share "
        f"{float((g.grad != 0).float().mean()):.4f}")

    t0 = time.perf_counter()
    true3 = bake_scene(config3_scene(FIT_SIZE, device=dev), FIT_SIZE, cfg)
    cam3 = make_camera(CameraConfig(width=FIT_IMAGE, height=FIT_IMAGE))
    with torch.no_grad():
        target3 = render_image(true3, cam3, cfg, medium)[..., :3]
    torch.cuda.synchronize()
    log(f"config 3 target: baked {FIT_SIZE}^3 cloud+smoke, rendered "
        f"{FIT_IMAGE}x{FIT_IMAGE} in {time.perf_counter() - t0:.2f} s")
    before = counts()
    clock = StepClock()
    t0 = time.perf_counter()
    res = fit_grid(target3, cam3, cfg, medium, LightConfig(),
                   grid_size=FIT_SIZE, steps=FIT_STEPS,
                   learning_rate=FIT_LR, metrics=clock)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = tuple(a - b for a, b in zip(counts(), before))
    train_launches = counts()
    log(f"config 3 fit: losses {[f'{x:.6e}' for x in res.losses]}, "
        f"skipped {res.skipped_steps}, launches (fwd, bwd) {fit_launches}, "
        f"{fit_s:.2f} s with the plan build")
    if fit_launches != (FIT_STEPS, FIT_STEPS):
        fail(f"fit launched (fwd, bwd) {fit_launches}, expected "
             f"({FIT_STEPS}, {FIT_STEPS})")
    if res.skipped_steps or not all(math.isfinite(x) for x in res.losses) \
            or not res.losses[-1] < res.losses[0]:
        fail(f"config 3 fit did not descend: losses {res.losses}, skipped "
             f"{res.skipped_steps}")
    (s0, c0), (s1, c1) = clock.marks[0], clock.marks[-1]
    fit_step_ms = (c1 - c0) * 1e3 / (s1 - s0)
    log(f"training path: launches (fwd, bwd) {train_launches}")

    # 8. Timing at the flagship, default camera.
    fwd_args, flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm), plan,
                                            cfg, medium)
    fwd_args = (fwd_args[0].contiguous(), *fwd_args[1:])
    kernel_ms = cuda_ms(lambda: sweep_fwd.launch_kernel(
        *fwd_args, cfg.emission, flip, False))
    plain_ms = cuda_ms(lambda: sweep_fwd.sweep_fwd_reference(
        *fwd_args, emission=cfg.emission, flip=flip,
        address_mode=cfg.address_mode), runs=5, warmup=1)
    bwd_ms = cuda_ms(lambda: sweep_bwd.launch_kernel(*bwd_args))
    bwd_plain_ms = cuda_ms(lambda: sweep_bwd.sweep_bwd_reference(
        *bwd_args[:11], emission=bwd_args[11], flip=bwd_args[12],
        address_mode=cfg.address_mode), runs=5, warmup=1)
    maps = tuple(sweep_fwd.launch_kernel(*fwd_args, cfg.emission, flip,
                                         False).unbind(0))
    finish_ms = cuda_ms(lambda: finish_image(maps, plan, cfg, medium))
    lin = tuple(m.clone().requires_grad_() for m in maps)

    def finish_fwdbwd():
        (finish_image(lin, plan, cfg, medium)[..., :3] ** 2).sum().backward()
    finish_fb_ms = cuda_ms(finish_fwdbwd)
    render_ms = cuda_ms(lambda: render_image(grid, cam, cfg, medium,
                                             plan=plan))

    def fwdbwd():
        g.grad = None
        (render_image(g, cam, cfg, medium, plan=plan)[..., :3] ** 2).sum() \
            .backward()
    fwdbwd_ms = cuda_ms(fwdbwd)
    t0 = time.perf_counter()
    plan_for(cam, grid.shape, cfg, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    rays = WIDTH * HEIGHT
    log(f"[{gpu_line}] flagship {VOLUME}^3 at {WIDTH}x{HEIGHT}, base "
        f"{plan.base_shape}, {plan.slice_z.shape[0]} slices:")
    log(f"  sweep_fwd kernel          {kernel_ms:.3f} ms")
    log(f"  sweep_fwd plain version   {plain_ms:.3f} ms")
    log(f"  sweep_bwd kernel          {bwd_ms:.3f} ms")
    log(f"  sweep_bwd plain version   {bwd_plain_ms:.3f} ms")
    log(f"  warp + finish forward     {finish_ms:.3f} ms")
    log(f"  warp + finish fwd+bwd     {finish_fb_ms:.3f} ms (backward "
        f"~{finish_fb_ms - finish_ms:.3f} ms)")
    log(f"  render_image              {render_ms:.3f} ms = "
        f"{rays / (render_ms * 1e-3):.4g} forward rays/s (plan excluded)")
    log(f"  forward+backward step     {fwdbwd_ms:.3f} ms = "
        f"{rays / (fwdbwd_ms * 1e-3):.4g} fwd+bwd rays/s (plan excluded)")
    log(f"  plan build (host)         {plan_s * 1e3:.1f} ms")
    log(f"[{gpu_line}] config 3 fit {FIT_SIZE}^3 at {FIT_IMAGE}x"
        f"{FIT_IMAGE}: {fit_step_ms:.3f} ms per step (host clock, steps "
        f"{s0 + 1}-{s1}), loss {res.losses[0]:.6e} -> {res.losses[-1]:.6e}")
    profile_fwdbwd(fwdbwd, out_dir)

    # 9. Results.
    print(json.dumps({"kernels": [{
        "name": "sweep_fwd",
        "route": "cuda",
        "source": "volumetricrenderer_tpu_torch/kernels/csrc/sweep_fwd.cu",
        "replaces": "volumetricrenderer_tpu/kernels/sweep_pallas.py:729",
        "launches": serve_launches[0] + train_launches[0],
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "sweep_bwd",
        "route": "cuda",
        "source": "volumetricrenderer_tpu_torch/kernels/csrc/sweep_bwd.cu",
        "replaces": "volumetricrenderer_tpu/kernels/sweep_pallas.py:930",
        "launches": serve_launches[1] + train_launches[1],
        "max_abs_err": max(bwd_errs),
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
