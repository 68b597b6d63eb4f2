#!/usr/bin/env python3
"""Smoke run of the PyTorch port's forward render on one CUDA GPU.

    python3 chip_smoke.py [--out DIR]

Drives volumetricrenderer_tpu_torch only (no JAX) through its main path:

1. device: requires torch.cuda.is_available(); prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the hand-written sweep kernel (kernels/csrc/sweep_fwd.cu)
   from the checkout with nvcc and prints the build time and ptxas report;
3. kernel against its plain PyTorch version at small shapes: five eyes
   (three sweep axes, both signs) x emission/absorption x
   mirror/clamp/wrap, plus sub-voxel slicing (n_slices != depth);
4. the flagship forward: cloud_volume(256, 7) on the card, rendered through
   render_image at 1920x1080 for the default camera and three orbit
   cameras (one plan each), with the kernel's launch count read around
   those four renders; each frame must be finite with alpha in [0, 1],
   and its base maps and image must match the plain version's;
5. timing with CUDA events (median of 12 after warm-up): the kernel, the
   plain version, the warp and finish, and render_image without the plan
   build (timed once on the host clock);
6. prints a JSON line of kernel results, then the last line
   {"ok": true, "device": {...}}.

Any failure raises, so the exit code is non-zero and no result is printed.
The default frame is saved as a PNG in --out (default: the package's
_build/ directory, which git ignores).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from volumetricrenderer_tpu_torch import (CameraConfig, MediumConfig,
                                          RenderConfig, cloud_volume,
                                          make_camera, orbit_camera, plan_for,
                                          render_image)
from volumetricrenderer_tpu_torch.kernels import sweep_fwd
from volumetricrenderer_tpu_torch.ops.sweep import finish_image
from volumetricrenderer_tpu_torch.utils.image import write_png

# Kernel and plain version take the same per-pixel, front-to-back slice
# order and the same separately rounded tap coordinates (the kernel builds
# with --fmad=false), so they differ only in the order of the bilinear
# tap sum (four products in the kernel, two banded matmuls in the plain
# version) and in expf's last bit, compounded over at most 256 slices:
# ~1e-6 on maps in [0, 1]. The tolerance is the JAX tests' own
# (tests/test_sweep_pallas.py), which holds the TPU kernels to the jnp
# sweep.
RTOL, ATOL = 2e-4, 2e-5

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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None,
                        help="directory for the flagship PNG")
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
    # The plain version's matmuls run in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 2. Build.
    info = sweep_fwd.build_kernel()
    log(f"build: {info['seconds']:.1f} s -> {info['path']}")
    for line in info["log"].strip().splitlines():
        log(f"  nvcc: {line}")

    # 3. Kernel against the plain version at small shapes.
    errs = []
    rng = np.random.default_rng(0)
    small = torch.tensor(rng.uniform(0.2, 1.0, (16, 16, 16)),
                         dtype=torch.float32, device=dev)
    medium = MediumConfig(combine="single", density=8.0)
    cases = [(eye, ax, sg, em, mode, None)
             for eye, ax, sg in SMALL_EYES
             for em in (True, False)
             for mode in ("mirror", "clamp", "wrap")]
    cases += [(SMALL_EYES[0][0], 0, -1, em, "mirror", 24)
              for em in (True, False)]
    for eye, axis, sign, emission, mode, n_slices in cases:
        cfg = RenderConfig(emission=emission, quadrature="sliced",
                           address_mode=mode)
        cam = make_camera(CameraConfig(eye=eye, width=96, height=64))
        plan = plan_for(cam, small.shape, cfg, n_slices=n_slices, device=dev)
        if (plan.axis, plan.sign) != (axis, sign):
            fail(f"eye {eye}: plan sweeps axis {plan.axis} sign {plan.sign},"
                 f" expected {axis} {sign}")
        got, want = maps_both(small, plan, cfg, medium)
        e = max(check_close(g, w, f"small eye={eye} emission={emission} "
                            f"{mode} n_slices={n_slices} {name}")
                for g, w, name in zip(got, want,
                                      ("acc", "trans", "wsum", "hit")))
        errs.append(e)
        log(f"small eye={eye} axis={axis} sign={sign:+d} "
            f"emission={emission} {mode} n_slices={n_slices}: "
            f"max abs err {e:.3e}")

    # 4. The flagship forward: a few requests through render_image.
    cfg = RenderConfig(emission=True, quadrature="sliced")
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
    sweep_fwd.launches = 0
    for name, cam in cams:
        before = sweep_fwd.launches
        plan = plan_for(cam, grid.shape, cfg, device=dev)
        img = render_image(grid, cam, cfg, medium, plan=plan)
        torch.cuda.synchronize()
        if sweep_fwd.launches != before + 1:
            fail(f"{name}: render_image launched the sweep kernel "
                 f"{sweep_fwd.launches - before} times, expected 1")
        frames.append((name, plan, img))
    main_launches = sweep_fwd.launches
    log(f"main path: {len(frames)} frames, sweep kernel launches "
        f"{main_launches}")

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

    out_dir = args.out or os.path.join(
        os.path.dirname(os.path.abspath(sweep_fwd.__file__)), os.pardir,
        "_build")
    os.makedirs(out_dir, exist_ok=True)
    png = write_png(os.path.join(out_dir, "chip_smoke_flagship.png"),
                    frames[0][2])
    log(f"saved {os.path.normpath(png)}")

    # 5. Timing at the flagship, default camera.
    _, plan, _ = frames[0]
    cam = cams[0][1]
    (stack, *rest), flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm),
                                                  plan, cfg, medium)
    inputs = (stack.contiguous(), *rest)
    kernel_ms = cuda_ms(lambda: sweep_fwd.launch_kernel(
        *inputs, cfg.emission, flip, False))
    plain_ms = cuda_ms(lambda: sweep_fwd.sweep_fwd_reference(
        *inputs, emission=cfg.emission, flip=flip,
        address_mode=cfg.address_mode))
    maps = tuple(sweep_fwd.launch_kernel(*inputs, cfg.emission, flip,
                                         False).unbind(0))
    finish_ms = cuda_ms(lambda: finish_image(maps, plan, cfg, medium))
    render_ms = cuda_ms(lambda: render_image(grid, cam, cfg, medium,
                                             plan=plan))
    t0 = time.perf_counter()
    plan_for(cam, grid.shape, cfg, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    rays = WIDTH * HEIGHT
    log(f"[{gpu_line}] flagship {VOLUME}^3 at {WIDTH}x{HEIGHT}, base "
        f"{plan.base_shape}, {plan.slice_z.shape[0]} slices:")
    log(f"  sweep kernel      {kernel_ms:.3f} ms")
    log(f"  plain version     {plain_ms:.3f} ms")
    log(f"  warp + finish     {finish_ms:.3f} ms")
    log(f"  render_image      {render_ms:.3f} ms = "
        f"{rays / (render_ms * 1e-3):.4g} forward rays/s (plan excluded)")
    log(f"  kernel alone      {rays / (kernel_ms * 1e-3):.4g} rays/s")
    log(f"  plan build (host) {plan_s * 1e3:.1f} ms")

    # 6. Results.
    print(json.dumps({"kernels": [{
        "name": "sweep_fwd",
        "route": "cuda",
        "source": "volumetricrenderer_tpu_torch/kernels/csrc/sweep_fwd.cu",
        "replaces": "volumetricrenderer_tpu/kernels/sweep_pallas.py:729",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
