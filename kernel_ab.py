#!/usr/bin/env python3
"""A/B of the sweep kernels against another copy of their sources, in turns
on one CUDA GPU, with the ladder of the tiled schedule between them: the
single-channel K1 (kernels/csrc/sweep_fwd.cu) and K2 (sweep_bwd.cu), or with
--ref the 4-channel reference-medium K4 (sweep_ref_fwd.cu) and K5
(sweep_ref_bwd.cu).

    python3 kernel_ab.py --other DIR [--ref] [--out DIR] [--runs N]

DIR holds another tree's volumetricrenderer_tpu_torch/ package: for
example an earlier commit's,

    mkdir -p DIR && git archive REV volumetricrenderer_tpu_torch \\
        | tar -x -C DIR

(a directory that .gitignore lists, such as volumetricrenderer_tpu_torch/
_build/other). Its kernels/csrc/ holds the other sweep_fwd.cu and
sweep_bwd.cu (with --ref: sweep_ref_fwd.cu and sweep_ref_bwd.cu) and the
headers they include. Where its kernels/build.py has stage_buffers, its K1
and K2 take the tiled C interface (a stage and a tally argument) and
launch with the window buffers that its own stage_buffers gives; else the
per-pixel kernels' (no stage and no tally arguments).

K1 and K2: five settings, the flagship forward+backward plan
(cloud_volume(256, 7), default camera at 1920x1080: 1536^2 base, 256
slices) in float32 and bfloat16, config 4's orbit frame 0 with its light
volume (LightConfig(shadow_steps=32)) in both, and config 5's plan
(cloud_volume(512, 7) at 1920x1080: 1536^2 base, 512 slices) in float32,
where `config5.fit` runs K2. K4 and K5 (--ref):
the reference preset (build_volume(VolumeConfig()), 128^3 x 4, default
camera at 1280x720: 1024^2 base, 128 slices, a seeded (4, 3) scroll) with
emission in float32 and bfloat16, with absorption, with a light volume at
density 8 in float32 and bfloat16, and 256^3 x 4 at 1920x1080 with
emission. For each, both kernels of each version run on the same inputs:

* the other forward's maps against this one's, staged and with every
  tile-slice read through global memory (stage=0): equal bit for bit, or
  the script fails;
* the other backward's gradients (dG or dL, and the light's) against this
  one's, both paths: within 2e-4 of the maximum (the atomics sum in
  another order each run);
* timings in turns, other / global / staged / staged / global / other,
  each a median of --runs CUDA-event intervals after two warm-ups.

It prints the nvcc/ptxas report of every build, one line per timing, the
tile-slice tallies of K1 and K2, and the results as one JSON line (also
written to --out/kernel_ab.json). It needs a GPU and fails without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import torch

import numpy as np

from volumetricrenderer_tpu_torch import (CameraConfig, LightConfig,
                                          MediumConfig, RenderConfig,
                                          VolumeConfig, build_volume,
                                          cloud_volume,
                                          light_transmittance_volume,
                                          make_camera, orbit_camera,
                                          plan_for)
from volumetricrenderer_tpu_torch.kernels import (build, sweep_bwd,
                                                  sweep_fwd, sweep_ref_bwd,
                                                  sweep_ref_fwd)

WIDTH, HEIGHT, VOLUME = 1920, 1080, 256
CONFIG5_VOLUME = 512
GRAD_TOL = 2e-4
# The C launchers' pointer arguments before their int arguments (the other
# copy's interface: 7 ints and the stream after them, or 9 for K1 and K2).
N_PTRS = {"sweep_fwd": 8, "sweep_bwd": 14, "sweep_ref_fwd": 8,
          "sweep_ref_bwd": 14}
N_INTS = {"sweep_fwd": 9, "sweep_bwd": 9, "sweep_ref_fwd": 7,
          "sweep_ref_bwd": 7}


def log(msg):
    print(msg, flush=True)


def other_buffers(root):
    """The window buffers a volume that the other tree's K1 and K2 take,
    (forward, backward), from its own kernels/build.py stage_buffers, run
    in a process of its own on that tree; None where it has none."""
    code = ("from volumetricrenderer_tpu_torch.kernels import build\n"
            "f = getattr(build, 'stage_buffers', None)\n"
            "print(None if f is None else "
            "[f(backward, False) for backward in (False, True)])")
    root = os.path.abspath(root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"the other tree's build.py: {proc.stderr}")
    got = json.loads(proc.stdout.strip().splitlines()[-1].replace(
        "None", "null"))
    return None if got is None else tuple(got)


def build_other(src_dir, names, tiled=False):
    """Compile the other copies of `names` (e.g. sweep_fwd, sweep_bwd) with
    the port's flags; returns ({name: launcher}, {name: nvcc output}).
    tiled: their launchers take a stage and a tally after the ints."""
    fns, logs = {}, {}
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    for name in names:
        src = os.path.join(src_dir, name + ".cu")
        lib = os.path.join(build.BUILD_DIR,
                           f"other-{name}-{build.source_key(src)[:16]}.so")
        t0 = time.perf_counter()
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
                               src], capture_output=True, text=True)
        logs[name] = (f"{time.perf_counter() - t0:.1f} s\n"
                      + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{logs[name]}")
        fn = getattr(ctypes.CDLL(lib), name + "_launch")
        fn.argtypes = [ctypes.c_void_p] * N_PTRS[name] \
            + [ctypes.c_int] * (N_INTS[name] + tiled) \
            + [ctypes.c_void_p] * (1 + tiled)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, logs


def ptr(t):
    return None if t is None else t.data_ptr()


def elem_of(stack):
    return build.ELEM_BF16 if stack.dtype == torch.bfloat16 else \
        build.ELEM_F32


def stage_args(cap):
    """The tiled interface's stage and (no) tally, or nothing."""
    return () if cap is None else (cap, None)


def other_fwd(fn, stack, args, flip, light, cap=None):
    slice_z, v, u, seg, params = args
    S, A, B = stack.shape
    out = torch.empty((4, v.numel(), u.numel()), dtype=torch.float32,
                      device=stack.device)
    rc = fn(ptr(stack), ptr(light), ptr(slice_z), ptr(v), ptr(u), ptr(seg),
            ptr(params), ptr(out), S, A, B, v.numel(), u.numel(), 1,
            int(flip), 0, elem_of(stack), *stage_args(cap),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"other sweep_fwd launch failed: CUDA error {rc}")
    return out


def other_bwd(fn, stack, args, cts, maps, flip, light, cap=None):
    slice_z, v, u, seg, params = args
    S, A, B = stack.shape
    dG = torch.zeros((S, A, B), dtype=torch.float32, device=stack.device)
    dL = torch.zeros_like(dG) if light is not None else None
    rc = fn(ptr(stack), ptr(light), ptr(slice_z), ptr(v), ptr(u), ptr(seg),
            ptr(params), None, ptr(cts[1]), ptr(cts[2]), ptr(maps[1]),
            ptr(maps[2]), ptr(dG), ptr(dL), S, A, B, v.numel(), u.numel(), 1,
            int(flip), 0, elem_of(stack), *stage_args(cap),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"other sweep_bwd launch failed: CUDA error {rc}")
    return dG if light is None else (dG, dL)


def cuda_ms(fn, runs, warmup=2):
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


def grad_err(got, want):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale


def time_turns(name, kernel, fns, runs, gpu_line):
    """Times fns["other"], ["global"] and ["staged"] in turns, other /
    global / staged / staged / global / other; logs and returns the
    times."""
    times = {k: [] for k in fns}
    for k in ("other", "global", "staged", "staged", "global", "other"):
        times[k].append(cuda_ms(fns[k], runs))
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"[{gpu_line}] {name} {kernel}: other "
        + " / ".join(f"{t:.3f}" for t in times["other"])
        + " ms, tiled global " + " / ".join(f"{t:.3f}" for t in
                                            times["global"])
        + " ms, tiled staged " + " / ".join(f"{t:.3f}" for t in
                                            times["staged"])
        + f" ms; other / staged {med['other'] / med['staged']:.2f}x, "
        f"other / global {med['other'] / med['global']:.2f}x")
    return times


def setting(name, stack, args, flip, light, other, runs, gpu_line):
    """Checks and times both kernels of both versions on one setting."""
    res = {"setting": name, "base": list(args[1].shape + args[2].shape),
           "slices": int(args[0].shape[0]), "dtype": str(stack.dtype)}
    gen = torch.Generator(device=stack.device).manual_seed(3)
    cts = [torch.randn(args[1].numel(), args[2].numel(), device=stack.device,
                       generator=gen) for _ in range(3)]
    sweep_fwd.tiles.reset()
    staged = sweep_fwd.launch_kernel(stack, *args, True, flip, False, light)
    done, glob = sweep_fwd.tiles.read()
    res["stage_texels"] = build.stage_for(*args[:3], args[4], stack.shape[1],
                                          stack.shape[2], False)
    res["tile_slices"], res["tile_slices_global"] = done, glob
    # The other copy's stages, where it takes the tiled interface.
    vols = 1 if light is None else 2
    cap_f, cap_b = (None, None) if other["buffers"] is None else (
        build.stage_cap(res["stage_texels"], b * vols)
        for b in other["buffers"])
    gmaps = sweep_fwd.launch_kernel(stack, *args, True, flip, False, light,
                                    stage=0)
    omaps = other_fwd(other["sweep_fwd"], stack, args, flip, light, cap_f)
    torch.cuda.synchronize()
    if not (torch.equal(staged, omaps) and torch.equal(gmaps, omaps)):
        raise RuntimeError(
            f"{name}: K1 differs from the other K1: max abs err "
            f"{float((staged - omaps).abs().max()):.3e} (staged), "
            f"{float((gmaps - omaps).abs().max()):.3e} (global)")
    maps = staged

    def new_bwd(stage=None):
        return sweep_bwd.launch_kernel(stack, *args, None, cts[1], cts[2],
                                       maps[1], maps[2], True, flip, False,
                                       light=light, stage=stage)
    sweep_bwd.tiles.reset()
    grads = {"staged": new_bwd()}
    bdone, bglob = sweep_bwd.tiles.read()
    res["bwd_tile_slices"], res["bwd_tile_slices_global"] = bdone, bglob
    grads["global"] = new_bwd(0)
    grads["other"] = other_bwd(other["sweep_bwd"], stack, args, cts, maps,
                               flip, light, cap_b)
    torch.cuda.synchronize()
    if light is None:
        grads = {k: (g, None) for k, g in grads.items()}
    errs = {}
    for k in ("staged", "global"):
        errs[f"dG_{k}"] = grad_err(grads[k][0], grads["other"][0])
        if light is not None:
            errs[f"dL_{k}"] = grad_err(grads[k][1], grads["other"][1])
    res["grad_rel_err"] = errs
    if max(errs.values()) > GRAD_TOL:
        raise RuntimeError(f"{name}: K2 differs from the other K2: {errs}")

    fwd = {"other": lambda: other_fwd(other["sweep_fwd"], stack, args, flip,
                                      light, cap_f),
           "global": lambda: sweep_fwd.launch_kernel(
               stack, *args, True, flip, False, light, stage=0),
           "staged": lambda: sweep_fwd.launch_kernel(
               stack, *args, True, flip, False, light)}
    bwd = {"other": lambda: other_bwd(other["sweep_bwd"], stack, args, cts,
                                      maps, flip, light, cap_b),
           "global": lambda: new_bwd(0), "staged": new_bwd}
    for kernel, fns in (("K1", fwd), ("K2", bwd)):
        res[kernel] = time_turns(name, kernel, fns, runs, gpu_line)
    log(f"  {name}: base {tuple(res['base'])}, {res['slices']} slices, stage "
        f"{res['stage_texels']} texels, {done} tile-slices of which {glob} "
        f"through global memory; K2 {bdone} of which {bglob} through global "
        f"memory; K2 error {errs}")
    return res


def other_ref_fwd(fn, L, args, emission, light):
    slice_z, v, u, seg, params = args
    S, _, A, B = L.shape
    out = torch.empty((4, v.numel(), u.numel()), dtype=torch.float32,
                      device=L.device)
    rc = fn(ptr(L), ptr(light), ptr(slice_z), ptr(v), ptr(u), ptr(seg),
            ptr(params), ptr(out), S, A, B, v.numel(), u.numel(),
            int(emission), elem_of(L),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"other sweep_ref_fwd launch failed: CUDA error "
                           f"{rc}")
    return out


def other_ref_bwd(fn, L, args, cts, maps, emission, light):
    slice_z, v, u, seg, params = args
    S, _, A, B = L.shape
    dL = torch.zeros(L.shape, dtype=torch.float32, device=L.device)
    dl = (torch.zeros(light.shape, dtype=torch.float32, device=L.device)
          if light is not None else None)
    rc = fn(ptr(L), ptr(light), ptr(slice_z), ptr(v), ptr(u), ptr(seg),
            ptr(params), ptr(cts[0]), ptr(cts[1]), ptr(cts[2]),
            ptr(maps[1]), ptr(maps[2]), ptr(dL), ptr(dl), S, A, B, v.numel(),
            u.numel(), int(emission), elem_of(L),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"other sweep_ref_bwd launch failed: CUDA error "
                           f"{rc}")
    return dL if light is None else (dL, dl)


def ref_setting(name, L, args, emission, light, other, runs, gpu_line):
    """K4 and K5 of both versions on one setting: checks, then timings."""
    slice_z, v, u, _, params = args
    A, B = L.shape[2], L.shape[3]
    res = {"setting": name, "base": [v.numel(), u.numel()],
           "slices": int(slice_z.shape[0]), "dtype": str(L.dtype),
           "emission": emission}
    gen = torch.Generator(device=L.device).manual_seed(3)
    cts = [torch.randn(v.numel(), u.numel(), device=L.device, generator=gen)
           for _ in range(3)]
    lit = light is not None
    stage = build.ref_stage_for(slice_z, v, u, params, A, B, light=lit)
    spans = build.ref_tile_spans(slice_z, v, u, params, A, B)
    lspans = build.tile_spans(slice_z, v, u, params, A, B, False) \
        if lit else None
    res["stage_bound"] = stage
    res["stage_texels"] = build.ref_stage_texels(spans, lspans)
    res["cap_fwd"] = build.ref_stage_cap(stage, False, lit)
    res["cap_bwd"] = build.ref_stage_cap(stage, True, lit)

    def new_fwd(st=stage):
        return sweep_ref_fwd.launch_kernel(L, *args, emission, light,
                                           stage=st)
    sweep_ref_fwd.tiles.reset()
    staged = new_fwd()
    done, glob = sweep_ref_fwd.tiles.read()
    res["tile_slices"], res["tile_slices_global"] = done, glob
    res["host_tile_slices"] = build.ref_tile_slices(spans, res["cap_fwd"],
                                                    lspans)
    gmaps = new_fwd(0)
    omaps = other_ref_fwd(other["sweep_ref_fwd"], L, args, emission, light)
    torch.cuda.synchronize()
    if not (torch.equal(staged, omaps) and torch.equal(gmaps, omaps)):
        raise RuntimeError(
            f"{name}: K4 differs from the other K4: max abs err "
            f"{float((staged - omaps).abs().max()):.3e} (staged), "
            f"{float((gmaps - omaps).abs().max()):.3e} (global)")
    maps = staged

    def new_bwd(st=stage):
        return sweep_ref_bwd.launch_kernel(
            L, *args, cts[0], cts[1], cts[2], maps[1], maps[2],
            emission=emission, light=light, stage=st)
    sweep_ref_bwd.tiles.reset()
    grads = {"staged": new_bwd()}
    res["bwd_tile_slices"] = sweep_ref_bwd.tiles.read()
    grads["global"] = new_bwd(0)
    grads["other"] = other_ref_bwd(other["sweep_ref_bwd"], L, args, cts,
                                   maps, emission, light)
    torch.cuda.synchronize()
    if not lit:
        grads = {k: (g, None) for k, g in grads.items()}
    errs = {}
    for k in ("staged", "global"):
        errs[f"dL_{k}"] = grad_err(grads[k][0], grads["other"][0])
        if lit:
            errs[f"dlight_{k}"] = grad_err(grads[k][1], grads["other"][1])
    res["grad_rel_err"] = errs
    if max(errs.values()) > GRAD_TOL:
        raise RuntimeError(f"{name}: K5 differs from the other K5: {errs}")

    fwd = {"other": lambda: other_ref_fwd(other["sweep_ref_fwd"], L, args,
                                          emission, light),
           "global": lambda: new_fwd(0), "staged": new_fwd}
    bwd = {"other": lambda: other_ref_bwd(other["sweep_ref_bwd"], L, args,
                                          cts, maps, emission, light),
           "global": lambda: new_bwd(0), "staged": new_bwd}
    for kernel, fns in (("K4", fwd), ("K5", bwd)):
        res[kernel] = time_turns(name, kernel, fns, runs, gpu_line)
    log(f"  {name}: base {tuple(res['base'])}, {res['slices']} slices, "
        f"stage bound {stage} slots (largest window {res['stage_texels']}), "
        f"cap {res['cap_fwd']} / {res['cap_bwd']}; K4 {done} tile-slices of "
        f"which {glob} through global memory (host mirror "
        f"{res['host_tile_slices']}), K5 {res['bwd_tile_slices']}; K5 error "
        f"{errs}")
    return res


def ref_settings(other, runs, gpu_line, dev):
    """The --ref settings (module docstring)."""
    results = []
    scroll = torch.tensor(np.random.default_rng(5).uniform(-1.5, 1.5,
                                                           (4, 3)),
                          dtype=torch.float32, device=dev)
    grid4 = build_volume(VolumeConfig(), device=dev)
    cam = make_camera(CameraConfig())
    for em in (True, False):
        cfg = RenderConfig(emission=em, quadrature="sliced")
        plan = plan_for(cam, grid4.shape, cfg, device=dev)
        L, *args = sweep_ref_fwd.sweep_ref_inputs(
            grid4.permute(plan.perm + (3,)), plan, cfg, MediumConfig(), None,
            scroll)
        L = L.contiguous()
        mode = "emission" if em else "absorption"
        results.append(ref_setting(f"reference preset, {mode}", L, args, em,
                                   None, other, runs, gpu_line))
        if em:
            results.append(ref_setting(
                "reference preset, emission, bfloat16",
                L.to(torch.bfloat16), args, em, None, other, runs, gpu_line))
    medium = MediumConfig(density=8.0)
    light = LightConfig(shadow_steps=32)
    cfg = RenderConfig(emission=True, quadrature="sliced")
    plan = plan_for(cam, grid4.shape, cfg, device=dev)
    L, *args = sweep_ref_fwd.sweep_ref_inputs(
        grid4.permute(plan.perm + (3,)), plan, cfg, medium, light, scroll)
    lvol = light_transmittance_volume(grid4, light, cfg, medium,
                                      scroll=scroll)
    slabs = sweep_ref_fwd.sweep_ref_light_slabs(lvol.permute(plan.perm),
                                                plan, cfg).contiguous()
    L = L.contiguous()
    results.append(ref_setting("reference preset, light, density 8", L,
                               args, True, slabs, other, runs, gpu_line))
    results.append(ref_setting(
        "reference preset, light, density 8, bfloat16",
        L.to(torch.bfloat16), args, True, slabs.to(torch.bfloat16), other,
        runs, gpu_line))
    big4 = build_volume(VolumeConfig(size=VOLUME), device=dev)
    cam_big = make_camera(CameraConfig(width=WIDTH, height=HEIGHT))
    plan = plan_for(cam_big, big4.shape, cfg, device=dev)
    L, *args = sweep_ref_fwd.sweep_ref_inputs(
        big4.permute(plan.perm + (3,)), plan, cfg, MediumConfig(), None,
        scroll)
    results.append(ref_setting(f"{VOLUME}^3 x 4 at {WIDTH}x{HEIGHT}, "
                               "emission", L.contiguous(), args, True, None,
                               other, runs, gpu_line))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True,
                        help="directory with another tree's "
                        "volumetricrenderer_tpu_torch/ package")
    parser.add_argument("--ref", action="store_true",
                        help="K4 and K5 (the reference medium) instead of "
                        "K1 and K2")
    parser.add_argument("--out", default=None)
    parser.add_argument("--runs", type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is False: "
                         "this script needs a CUDA GPU")
    gpu_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(gpu_line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    mods = ((("sweep_ref_fwd", sweep_ref_fwd), ("sweep_ref_bwd",
                                                 sweep_ref_bwd))
            if args.ref else (("sweep_fwd", sweep_fwd),
                              ("sweep_bwd", sweep_bwd)))
    for name, mod in mods:
        info = mod.build_kernel()
        log(f"build {name} (this tree): {info['seconds']:.1f} s")
        for line in info["log"].strip().splitlines():
            log(f"  nvcc: {line}")
    buffers = None if args.ref else other_buffers(args.other)
    other, logs = build_other(
        os.path.join(args.other, "volumetricrenderer_tpu_torch", "kernels",
                     "csrc"), [name for name, _ in mods], buffers is not None)
    other["buffers"] = buffers
    for name, text in logs.items():
        log(f"build {name} (other): " + text.splitlines()[0])
        for line in text.strip().splitlines()[1:]:
            log(f"  nvcc: {line}")

    if args.ref:
        return finish(ref_settings(other, args.runs, gpu_line, dev),
                      gpu_line, args.out, "kernel_ab_ref.json")
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    grid = cloud_volume(VOLUME, 7, device=dev)
    results = []

    cam = make_camera(CameraConfig(width=WIDTH, height=HEIGHT))
    plan = plan_for(cam, grid.shape, cfg, device=dev)
    (stack, *fargs), flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm),
                                                   plan, cfg, medium)
    stack = stack.contiguous()
    results.append(setting("flagship", stack, fargs, flip, None, other,
                           args.runs, gpu_line))
    results.append(setting("flagship bfloat16", stack.to(torch.bfloat16),
                           fargs, flip, None, other, args.runs, gpu_line))

    light = LightConfig(shadow_steps=32)
    cam4 = orbit_camera(0.0, width=WIDTH, height=HEIGHT)
    plan4 = plan_for(cam4, grid.shape, cfg, device=dev)
    (stack4, *fargs4), flip4 = sweep_fwd.sweep_inputs(
        grid.permute(plan4.perm), plan4, cfg, medium, light)
    lvol = light_transmittance_volume(grid, light, cfg, medium)
    lstack = sweep_fwd.sweep_light_stack(lvol.permute(plan4.perm), plan4,
                                         cfg).contiguous()
    results.append(setting("config 4 frame 0 with light",
                           stack4.contiguous(), fargs4, flip4, lstack, other,
                           args.runs, gpu_line))
    results.append(setting("config 4 frame 0 with light, bfloat16",
                           stack4.contiguous().to(torch.bfloat16), fargs4,
                           flip4, lstack.to(torch.bfloat16), other,
                           args.runs, gpu_line))
    del grid, stack, stack4, lstack, lvol

    grid5 = cloud_volume(CONFIG5_VOLUME, 7, device=dev)
    plan5 = plan_for(cam, grid5.shape, cfg, device=dev)
    (stack5, *fargs5), flip5 = sweep_fwd.sweep_inputs(
        grid5.permute(plan5.perm), plan5, cfg, medium)
    results.append(setting("config 5", stack5.contiguous(), fargs5, flip5,
                           None, other, args.runs, gpu_line))

    return finish(results, gpu_line, args.out, "kernel_ab.json")


def finish(results, gpu_line, out, name):
    """Prints the results as one JSON line, also written to out/name."""
    line = json.dumps({"device": gpu_line, "ab": results})
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, name), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
