#!/usr/bin/env python3
"""A/B of whole frames against another copy of the port, in turns on one
CUDA GPU, one process per turn: tells a regression of a frame's time from
drift between processes. The frames are the host-bound ones: config 4
(cloud_volume(256, 7) at 1920x1080, LightConfig(shadow_steps=32), the light
volume rebuilt in every frame) and the reference preset
(build_volume(VolumeConfig()), 128^3 x 4 at 1280x720, a seeded scroll).

    python3 frame_ab.py --other DIR [--rounds 2] [--out DIR]

DIR holds another tree's volumetricrenderer_tpu_torch/ package, for
example an earlier commit's,

    mkdir -p DIR && git archive REV volumetricrenderer_tpu_torch \\
        | tar -x -C DIR

(a directory that .gitignore lists, such as volumetricrenderer_tpu_torch/
_build/other; its kernels build into its own _build/). Each round runs the
other tree, then this one, each in a process of its own (`frame_ab.py
--measure ROOT LABEL`), which imports the package from ROOT and prints one
JSON line of [device ms, host ms] pairs, the medians of 12 CUDA-event
intervals after 2 warm-ups (16 for the orbit, one frame per plan):

* config4_frame: render_image over the 16 orbit cameras' natural plans,
  the light volume rebuilt inside; config4_frame_plan0 and
  config4_frame_no_grad the same at orbit frame 0, without and with
  torch.no_grad();
* light_sweep: light_transmittance_volume alone;
* render_given_lv and render_unshadowed: frame 0 given the light volume,
  and without shadows;
* reference_frame_emission_True / _False: the reference preset's frame.

The lines are printed as they come and written to --out/frame_ab.jsonl.
It needs a GPU and fails without one (--small --device cpu: a rehearsal
at 16^3 and 48x32, which times nothing).
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

RUNS, WARMUP, ORBIT = 12, 2, 16
SCROLL_SEED = 5  # chip_smoke.py's seeded_scroll(5)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def measure(T, label, device="cuda", small=False):
    """The frames of the package T (volumetricrenderer_tpu_torch, imported
    from the tree under test) on `device`; returns the line's fields. On
    the CPU (a rehearsal) each frame runs once and its times are None."""
    import numpy as np
    import torch
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def ms(fn, runs=RUNS):
        if not cuda:
            fn()
            return None
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize(dev)
        out, host = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
            host.append((time.perf_counter() - t0) * 1e3)
        return [statistics.median(out), statistics.median(host)]

    volume, width, height = (16, 48, 32) if small else (256, 1920, 1080)
    res = {"label": label, "package": os.path.dirname(T.__file__)}
    cfg = T.RenderConfig(emission=True, quadrature="sliced")
    med = T.MediumConfig(combine="single", density=8.0)
    light = T.LightConfig(shadow_steps=32)
    grid = T.cloud_volume(volume, 7, device=dev)
    cams = [T.orbit_camera(2 * math.pi * i / ORBIT, width=width,
                           height=height) for i in range(ORBIT)]
    t0 = time.perf_counter()
    plans = [T.plan_for(c, grid.shape, cfg, device=dev) for c in cams]
    if cuda:
        torch.cuda.synchronize(dev)
    res["plan_s_per_plan"] = (time.perf_counter() - t0) / ORBIT
    orbit = iter(plans * (RUNS + WARMUP + ORBIT))
    res["config4_frame"] = ms(lambda: T.render_image(
        grid, None, cfg, med, light, plan=next(orbit)), runs=ORBIT)
    res["config4_frame_plan0"] = ms(lambda: T.render_image(
        grid, cams[0], cfg, med, light, plan=plans[0]))
    res["light_sweep"] = ms(lambda: T.light_transmittance_volume(
        grid, light, cfg, med))
    lv = T.light_transmittance_volume(grid, light, cfg, med)
    res["render_given_lv"] = ms(lambda: T.render_image(
        grid, cams[0], cfg, med, light, plan=plans[0], light_volume=lv))
    res["render_unshadowed"] = ms(lambda: T.render_image(
        grid, cams[0], cfg, med, plan=plans[0]))
    with torch.no_grad():
        res["config4_frame_no_grad"] = ms(lambda: T.render_image(
            grid, cams[0], cfg, med, light, plan=plans[0]))

    grid4 = T.build_volume(T.VolumeConfig(size=8 if small else 128),
                           device=dev)
    cam4 = T.make_camera(T.CameraConfig(width=48, height=32) if small
                         else T.CameraConfig())
    scroll = torch.tensor(
        np.random.default_rng(SCROLL_SEED).uniform(-1.5, 1.5, (4, 3)),
        dtype=torch.float32, device=dev)
    for em in (True, False):
        c = T.RenderConfig(emission=em, quadrature="sliced")
        p4 = T.plan_for(cam4, grid4.shape, c, device=dev)
        res[f"reference_frame_emission_{em}"] = ms(lambda: T.render_image(
            grid4, cam4, c, T.MediumConfig(), scroll=scroll, plan=p4))
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", help="directory holding the other "
                        "tree's volumetricrenderer_tpu_torch/ package")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true",
                        help="16^3 at 48x32: a rehearsal on the CPU")
    parser.add_argument("--measure", nargs=2, metavar=("ROOT", "LABEL"),
                        help="(one turn) measure the package under ROOT")
    args = parser.parse_args(argv)
    if args.measure:
        root, label = args.measure
        sys.path.insert(0, os.path.abspath(root))
        import volumetricrenderer_tpu_torch as T
        if not T.__file__.startswith(sys.path[0] + os.sep):
            raise SystemExit(f"frame_ab: imported {T.__file__}, not the "
                             f"package under {root}")
        print(json.dumps(measure(T, label, args.device, args.small)),
              flush=True)
        return 0
    if not args.other:
        parser.error("--other is required")
    here = os.path.dirname(os.path.abspath(__file__))
    extra = ["--device", args.device] + (["--small"] if args.small else [])
    lines = []
    if args.device != "cpu":
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        log(gpu)
    for _ in range(args.rounds):
        for root, label in ((args.other, "other"), (here, "this")):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure",
                 root, label, *extra], cwd=here, capture_output=True,
                text=True, timeout=600)
            if proc.returncode != 0:
                log(proc.stderr)
                raise SystemExit(f"frame_ab: the {label} tree's turn exited "
                                 f"with {proc.returncode}")
            lines.append(proc.stdout.strip().splitlines()[-1])
            print(lines[-1], flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "frame_ab.jsonl"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
