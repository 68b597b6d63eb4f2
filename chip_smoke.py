#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU: the forward render
(serving) and the forward+backward render and fit (training), for the
single-channel medium and for the 4-channel reference medium, without and
with shadows (BASELINE config 4's light volume), in float32 and in the
bfloat16 stream mode, the preset front end (`cli render`, `cli info`), the
viewer front end (`serve`, `cli animate`) and the slab-sharded sweep of
BASELINE config 5 (parallel/).

    python3 chip_smoke.py [--out DIR]    (| tee DIR/log.txt to keep the output)

Drives volumetricrenderer_tpu_torch only (no JAX) through its main paths:

1. device: requires torch.cuda.is_available(); prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the four hand-written sweep kernels (kernels/csrc/
   sweep_fwd.cu, sweep_bwd.cu, sweep_ref_fwd.cu and sweep_ref_bwd.cu, one
   nvcc each, started together) and the light sweep's (light_sweep.cu)
   from the checkout and prints the build times and ptxas reports;
3. the forward kernel against its plain PyTorch version at small shapes:
   five eyes (three sweep axes, both signs) x emission/absorption x
   mirror/clamp/wrap, plus sub-voxel slicing (n_slices != depth);
4. the backward kernel against its plain version in the same cases plus
   the density-500 early-stop case, on seeded normal cotangents; in each
   case the plain version is also held to autograd of the forward's;
4b. the tiled schedule of K1 and K2 (kernels/csrc/sweep_tile.cuh) under
   stress (TILED_STRESS): a window across the wrap seam, ragged base grids
   that are no multiple of the tile, density 500 (tiles whose rays end at
   different slices), absorption, a light volume with lT exactly 1 and one
   stretched past [0, 1], bfloat16, texels denser than base pixels and a
   stage above 48 KB of shared memory; each with the stage the host sizes,
   with none (every tile-slice through global memory) and with half of it,
   K1's maps equal bit for bit across the three, both kernels held to the
   plain versions;
5. bench.py's gradient check through the kernels
   (volumetricrenderer_tpu_torch/bench.py validate_gradients, which the
   port's bench runs too): the sweep's grid gradient on an identity-warp
   plan against the per-ray oracle's, cloud_volume(24, 7) at 48x32;
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
   steps through the fit runner's workload and fit
   (tools/fit_config3.py; the loss must fall, no step skipped, 5 launches
   of each kernel);
8. timing with CUDA events (median after warm-up): both kernels and their
   plain versions, the warp (ops/sweep.py _WarpBilinear, whose backward is
   the 4-tap splat) alone and with the finish, forward and backward, and
   the splat's index_add_ (tools/measure_warp.py warp_timings, as on
   every training path below), render_image, and the flagship
   forward+backward step; the fit step between fit_grid's metric writes
   (tools/fit_config3.py StepClock); a torch.profiler table of the
   forward+backward step with the device's busy and idle share
   (tools/trace_flagship.py profile_fwdbwd), which fails if the step ran
   an index_put_ backward (the scatter autograd derives for a gather;
   every step profile below is held to the same);
9. the 4-channel reference-combine kernels against their plain versions
   at small shapes (16^3 x 4, 96x64): five eyes x emission/absorption x
   scroll in {none, reference_media_scroll(1.7), a seeded random (4, 3)
   scroll whose per-channel offsets are nonzero}, sub-voxel slicing and the
   density-500 early-stop case; in each the plain backward is also held to
   autograd of the plain forward; then the gradient check of step 5 with
   the 4-channel medium and the random scroll (24^3 x 4 at 48x32);
9b. the tiled schedule of K4 and K5 (kernels/csrc/sweep_ref_tile.cuh)
   under stress (REF_TILED_STRESS): seeded scrolls whose channel windows
   cross mirror folds, ragged base grids, absorption, a channel scale above
   1 (a window wider than the mirror's period) and a negative one, density
   500, a light volume with lT exactly 1 and one stretched past [0, 1],
   bfloat16 with light, and windows beyond what a stage may hold; each with
   the stage sized from the plan (build.ref_stage_for, which must hold the
   largest window), with none and with half the largest window, K4's maps
   equal bit for bit across the three, both kernels held to the plain
   versions, the tallies to the host mirror (build.ref_tile_slices);
10. the reference preset at full width, build_volume(VolumeConfig()) =
   128^3 x 4 at 1280x720: serving, eight frames through render_image
   (absorption and emission x reference_media_scroll at t = 0 and 1.7 and
   two seeded random scrolls), one forward-kernel launch each, every frame
   finite and non-empty with its base maps and image held to the plain
   version; training, one forward+backward step per mode (sum of rgb^2,
   gradient to the 4-channel grid, one launch of each kernel), dL held to
   the plain backward on the same cotangents; the launch counts are set to
   0 before each of the two paths and read after;
11. timing of that path (both kernels, their plain versions, the channel
   slab build forward and backward, the warp, render_image, the
   forward+backward step) at the preset and, timing only, at 256^3 x 4
   and 1920x1080, with a torch.profiler table of the preset's step;
12. the light branch of the four kernels at small shapes (16^3, 96x64):
   five eyes x mirror/wrap x the real light volume (exactly 1.0 where
   fully lit: the clip's tie) and that volume stretched to [-0.2, 1.3]
   (all three arms of the clip's subgradient), sub-voxel slicing and the
   density-500 early-stop case; maps, dG and dL against the plain
   versions, and the plain backward against autograd of the plain forward;
   the same for the 4-channel kernels with a seeded scroll and a light
   volume from materialize_sigma; then the gradient check with shadows,
   the light volume built from the grid inside the loss, single-channel
   and 4-channel (24^3 at 48x32);
13. config 4 at full width: cloud_volume(256, 7) at 1920x1080, emission,
   density 8, LightConfig(shadow_steps=32), eight orbit cameras around the
   full circle, the light volume rebuilt each frame by render_image;
   exactly one forward-kernel launch and one light-sweep launch per frame
   (counts set to 0 before, read after); every frame finite, alpha in
   [0, 1] and equal to the unshadowed frame's, rgb nowhere brighter and somewhere darker; the base
   maps of two frames (one per sweep sign) held to the plain version;
   training, one forward+backward step (sum of rgb^2, gradient to the grid
   through dG and through dL and the light sweep), one launch of each
   kernel and one of the light sweep's forward and adjoint, dG and dL held
   to the plain backward on the same cotangents;
14. the reference medium with shadows at the preset's width (128^3 x 4,
   1280x720, emission, density 8, seeded scrolls): two frames and one forward+backward
   step through the 4-channel kernels' light branch, counted and held to
   the plain versions in the same way;
15. timing of the shadowed paths: the light sweep's kernel at config 4
   (the forward equal bit for bit to its plain version, timed beside it as
   a yardstick; the adjoint held to its plain version and to autograd
   through the forward's at rtol 2e-4, atol 2e-4 * max|g|), each against
   its bound, light_transmittance_volume forward and
   forward+backward at 256^3, materialize_sigma at 128^3 x 4, the four
   kernels with a light volume and their plain versions, render_image
   with shadows per frame (plan reused, light volume rebuilt), the warp
   and the shadowed forward+backward step, with a torch.profiler table of
   that step;
16. (the results are printed last, step 26);
17. the bfloat16 stream mode (RenderConfig(dtype="bfloat16"): texels and
   tap weights rounded to bfloat16, everything else float32) at small
   shapes: torch's rounding against the device's on seeded weights and
   exact ties; the bfloat16 instantiations of the four kernels against
   the plain versions in the mode, without and with a light volume, in
   emission and absorption, on three axes, mirror/clamp/wrap, sub-voxel
   slicing and the density-500 early-stop case (maps within 1e-6,
   gradients within 1e-5 of their maximum), each plain backward also
   against autograd of the plain forward; the gradient check in the mode
   against the float32 oracle on the bfloat16-rounded grid;
18. the main paths in the mode at full width, the counts set to 0 before
   each and read after: the four flagship serving frames and the flagship
   forward+backward step; eight reference-preset frames and one step per
   mode; four config-4 orbit frames and one shadowed step; the reference
   medium with shadows at density 8, two frames and one step. Each frame
   is held to the plain version in the mode and to the float32 frame of
   the same view (max below 3e-2, mean below 3e-3), each step's gradients
   to the plain backward on the same bfloat16 stacks;
19. timing of the four kernels in bfloat16 beside float32 on the same
   plans, without and with a light volume; render_image and the step in
   the mode with a float32 grid (the cast included) and a bfloat16 grid;
20. the preset front end: `cli render --preset` for config1..config4 and
   `reference` at their own sizes (config1..4 must launch the forward
   kernel once, `reference` marches per ray and launches none), each PNG
   against render_image on the same grid, config2 also in bfloat16
   through render_preset, wall times with the volume and plan build;
   each of these frames (config2's bfloat16 one too) held to the plain
   version at the preset's own shapes: the forward kernel's base maps on
   grid[..., 0] (or the baked grid) and its light volume, and the frame
   against finish_image of the plain maps; `cli info`;
21. the viewer front end (serve.py, `cli animate`): serve's self-drive
   through loopback HTTP at config2 (128^3, 512x512, 32 frames) and config4
   (256^3, 1920x1080, shadows, 16 frames), the counts set to 0 before each:
   K1 launches once per frame rendered, no frame fails, the mouse moves the
   state; the last served frame equal to render_image at its state and
   plan bit for bit and within 1 level of the plain version's frame; fps,
   ms per frame, warm-up, the force_dims probe's seconds, plan-cache
   misses, PNG bytes; then on each served renderer a walk of 8 lattice
   states: the plan-cache miss's latency, the synchronizing calls while a
   cached state is dispatched (torch.cuda.set_sync_debug_mode), a loop of
   render_frame() against the FrameLoop's pace with two frames in flight,
   one frame split into dispatch, device, fetch and PNG encode, a plan's
   device bytes; `cli animate --preset config4 --orbit --frames 8 --video
   x.apng` at full width (8 launches, 8 PNGs, per-frame seconds and plan
   seconds, frame 0 equal to render_image with the forced-dims plan and
   within 1 level of the plain version's), and `cli animate --preset
   reference --frames 2` (no launch: the per-ray march);
22. the slab-sharded sweep (parallel/) at BASELINE config 5 (a 512^3 FBM
   cloud at 1920x1080, emission, density 8): (a) a 1x1 mesh on NCCL
   (world size 1, initialize_distributed on localhost): the sharded frame
   equal to render_image on the same plan bit for bit, the same at
   n_slices=128, three sharded train steps (loss falls, one K1 and one K2
   launch a step); (b) the slab split in one process, no process group:
   the per-rank body (sweep_sharded.local_sweep) on every block of 2 or 4
   slabs x 1 or 2 data ranks, the partials composited front to back
   (sweep_sharded.split_sweep),
   n_slab * n_data launches of K1 (K2 on seeded cotangents), maps held to
   the unsharded kernel's at 2e-4 with the early-stop gate off and the
   grid gradient at rtol 1e-3, atol 1e-3 * max; the preset's gate within
   20 eps of the unsharded frame; the same for the reference preset
   through K4/K5 (seeded scroll) and a small shadowed case through the
   light branch; K1/K2 held to their plain versions (gate off, maps 2e-4,
   dG 1e-3) on config 5's whole stack and on one block of each split
   (256 or 128 slices, 1536 or 768 base rows), K4/K5 on one reference
   block; (c) two ranks spawned on cuda:0: NCCL's refusal of two ranks on
   one device is probed, on that refusal alone (any other NCCL error
   fails) the ranks run over gloo (CUDA maps exchanged through host
   copies) and hold config 5's frame and gradient to the unsharded
   kernels; (d) the configurations no kernel covers
   (the reference medium with clamp or wrap, a light volume of another
   shape) through the general sweep on the card against the CPU, and a
   light volume with absorption through K1; no main path of the phase
   calls the general sweep; (e) timings: config5's render_image, the
   1x1 sharded frame and train step (with a torch.profiler table of the
   step), the warp, each local K1 and K2 of the 4x1 and 2x2 splits with
   its share of the bound, and the composite;
23. the port's north-star bench as a user runs it: `python3
   bench_torch.py` in a process of its own at full width (256^3,
   1920x1080), on the libraries step 2 built (none may be built again); its
   last line must hold every key, the gradient check passed, one K1 and one
   K2 launch per headline and bfloat16 step (the kernels' counters over the
   timed steps), no general-sweep call on those steps and some on the
   general sweep's A/B and the exit rates, no flagship ray ending early;
   the dense exit rate (density 200) it computes by the general sweep is
   held to the same rate from K1's trans map here within 1e-4, beside the
   TPU's recorded 0.0241 (not held); the line is logged whole;
24. the JAX repository's workload tools as the port's runners
   (volumetricrenderer_tpu_torch/tools/), each main() in this process at
   the JAX tool's full size (every runner's size variable unset), counted
   from 0: fit_config3 (256^3, 1024^2, 40 steps: one K1 for the target
   and 40 of K1 and K2, no step skipped, the loss falling at least 100x,
   its first loss logged beside FIT_r5.json's, the TPU's), anim_config4
   (16 frames of config 4, every K1 launch of the frames and the warm-ups
   with the light branch), scale512 (512^3 at 512, 256 and 128 slices,
   the forward and forward+backward phases' K1 and K2), serve_local (32
   states of config2 at 512^2, K1 per frame of the timed and warm-up
   rounds), measure_warp (no kernel) and trace_flagship (K1 and K2 once a
   profiled step and among its top device ops); each line parsed, held
   to its keys, to the card's name and to no general-sweep call, and
   logged whole;
25. the sharded path's entry points and the stage profiler as the port's
   runners, at full width with one rank per card present (tools.
   spawn_ranks: a process per rank, NCCL, each rank's launches its own
   counters from 0, reported in the line; this process launches none of
   theirs): multichip (the JAX dryrun_multichip's shadowed step: a finite
   loss, one K1 for the target and one K1 and K2 for the step on every
   rank), sharded_step (the JAX sharded_tpu.py at 256^3/1080p: the six
   variants' K1 and K2 per timed call, the sharded frame equal to the
   unsharded one bit for bit at one rank, six train steps whose loss falls,
   the 512^3 sweep at 128 slices forward+backward), scaling_rehearsal
   (every (data, slab) shape of the cards present, VOLT_SR_SHAPES, at
   128^3/512^2: each shape's loss falls, its K1 and K2 counted) and
   profile_parts in this process (the flagship's stages, K1 and K2 per
   stage, the general sweep's calls); every line parsed and held to its
   keys, the card and its launches, and logged whole;
26. prints a JSON line of kernel results (each kernel's launches on the
   main paths, error, time, plain version's time, and the least time the
   card could take for the same work, each also for the light variant and
   for the bfloat16 mode; the share of the bound; the registers of each
   instantiation and the most spilled bytes from ptxas; the tile-slices
   each kernel computed on the main paths and how many of those read
   through global memory, which must be none for K4 and K5; the launches
   on the sharded paths, `launches_sharded`, in the runners of step 24,
   `launches_tools`, and in step 25, `launches_runner_ranks` and
   `launches_profile_parts`), and an entry for the light sweep's kernel
   (its launches on the main paths, forward and adjoint, the adjoint's
   error, forward and adjoint times and bounds, the plain version's time,
   registers), with each
   time's share of its bound logged before it, and the script's wall time
   on a line of its own, then the last line {"ok": true, "device":
   {...}}. Every main path logs its tile-slices.

Any failure raises, so the exit code is non-zero and no result is printed.
One frame of each medium, one shadowed frame and the profile tables are
saved in --out (default: the package's _build/ directory, which git
ignores).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from volumetricrenderer_tpu_torch import (CameraConfig, LightConfig,
                                          MediumConfig, RenderConfig,
                                          VolumeConfig, build_volume,
                                          cloud_volume,
                                          light_transmittance_volume,
                                          make_camera, materialize_sigma,
                                          orbit_camera, plan_for,
                                          reference_media_scroll,
                                          render_image)
from volumetricrenderer_tpu_torch import bench, tools
from volumetricrenderer_tpu_torch.kernels import (light_sweep, sweep_bwd,
                                                  sweep_fwd, sweep_ref_bwd,
                                                  sweep_ref_fwd)
from volumetricrenderer_tpu_torch.kernels.round_probe import \
    round_weights_on_device
from volumetricrenderer_tpu_torch.models.scene import bake_scene
from volumetricrenderer_tpu_torch.ops import sweep as ops_sweep
from volumetricrenderer_tpu_torch.ops.integrate import render_rays_sliced
from volumetricrenderer_tpu_torch.ops.lighting import light_sweep_geometry
from volumetricrenderer_tpu_torch.ops.sweep import base_rays, finish_image, \
    sweep_render
from volumetricrenderer_tpu_torch.parallel.sweep_sharded import split_sweep
from volumetricrenderer_tpu_torch.tools import (fit_config3, measure_warp,
                                                trace_flagship)
from volumetricrenderer_tpu_torch.tools.fit_config3 import StepClock
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
# The reference preset's own width (config.py PRESETS["reference"]:
# VolumeConfig(), CameraConfig()), and the flagship's for a second timing.
REF_VOLUME, REF_WIDTH, REF_HEIGHT = 128, 1280, 720
REF_TIMES = (0.0, 1.7)
REF_SCROLL_SEEDS = (5, 6)

KERNELS = {  # name -> (module, source, the TPU kernel it replaces)
    "sweep_fwd": (sweep_fwd, "sweep_fwd.cu", 729),
    "sweep_bwd": (sweep_bwd, "sweep_bwd.cu", 930),
    "sweep_ref_fwd": (sweep_ref_fwd, "sweep_ref_fwd.cu", 1750),
    "sweep_ref_bwd": (sweep_ref_bwd, "sweep_ref_bwd.cu", 1914),
}
# The card's published peaks (H100 SXM data sheet): float32 outside the
# tensor cores, and device memory.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Float operations the swept function needs (emission, the mode that is
# timed), an exp counted as one. Per sample that is in the box and in front
# of the eye, FLOP_PER_SAMPLE; the tap indices and the fractions f, 1 - f
# depend on (slice, row, channel) or (slice, column, channel) only, so they
# are needed once per row and per column of a slice, FLOP_PER_LINE, not
# once per sample (the kernels here recompute them in every thread; the
# bound does not count that).
#   sweep_fwd: the bilinear sum (6 products, 3 adds = 9), sigma (1), exp's
#     argument (2), exp (1), alpha (1), wsum += T * alpha (2),
#     T *= 1 - alpha (2)                                              = 18
#   sweep_bwd: the forward's 18 for the replay, A~ (2), dsigma (5), its
#     sample_scale (1), the bilinear adjoint (6 products, 4 adds)     = 36
#   sweep_ref_fwd: four bilinear sums (36), the combine (4), exp's argument,
#     exp, alpha and the two carries (8)                              = 48
#   sweep_ref_bwd: the forward's 48, A~ (2), dsigma (5), its sample_scale
#     (1), the product rule on the combine's r0 * r1 and r2 + r3 (5), four
#     bilinear adjoints (40)                                          = 101
# With a light volume, forward: the light's bilinear sum (9), the clip (2),
# the shade (2) and its product into wsum (1) = 14 more; backward: those 14
# for the replay, shade in dsigma (1), dlT with the clip's subgradient (6)
# and the second bilinear adjoint (10) = 31 more.
FLOP_PER_SAMPLE = {"sweep_fwd": 18, "sweep_bwd": 36, "sweep_ref_fwd": 48,
                   "sweep_ref_bwd": 101,
                   "sweep_fwd+light": 32, "sweep_bwd+light": 67,
                   "sweep_ref_fwd+light": 62, "sweep_ref_bwd+light": 132}
#   one channel: the coordinate e + delta * slope (2), p = x * n - 0.5 (2),
#     floor (1), f (1), 1 - f (1)                                     = 7
#   four channels: the coordinate (2), then per channel its scale and
#     scroll (2) and p, floor, f, 1 - f (5)                           = 30
#   the single-channel light taps are the grid's own; the 4-channel
#     kernels' light taps are a fifth, unscaled set: p, floor, f, 1 - f = 5
FLOP_PER_LINE = {"sweep_fwd": 7, "sweep_bwd": 7, "sweep_ref_fwd": 30,
                 "sweep_ref_bwd": 30,
                 "sweep_fwd+light": 7, "sweep_bwd+light": 7,
                 "sweep_ref_fwd+light": 35, "sweep_ref_bwd+light": 35}
# Config 4 (config.py PRESETS["config4"], with the 3-D cloud the kernels
# take): eight orbit cameras around the full circle cross the x and y
# sectors with both signs and the z sector.
CONFIG4_FRAMES = 8
CONFIG4_LIGHT = LightConfig(shadow_steps=32)
# The reference medium with shadows: the preset's medium at density 8, as
# the JAX package's own test of this path takes it
# (tests/test_sweep_pallas_ref.py); at the preset's density 1 the cube
# stays above T = 0.9 and its shadows darken a pixel by less than 1e-3.
REF_SHADOW_MEDIUM = MediumConfig(density=8.0)


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
    return tools.median_ms(fn, "cuda", runs, warmup)[0]


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


class BackwardSpy:
    """Wraps a backward module's launch_kernel for the time of a `with`
    block and records (arguments, keyword arguments, result) of each
    launch, so the result can be held to the plain version afterwards."""

    def __init__(self, module):
        self.module, self.seen = module, []

    def __enter__(self):
        self.launch = self.module.launch_kernel

        def spy(*a, **kw):
            out = self.launch(*a, **kw)
            # The stage is the launch's, not the function's: the plain
            # version takes the other arguments.
            self.seen.append((a, {k: v for k, v in kw.items()
                                  if k != "stage"}, out))
            return out
        self.module.launch_kernel = spy
        return self

    def __exit__(self, *exc):
        self.module.launch_kernel = self.launch


def counts():
    """Launches of (sweep_fwd, sweep_bwd, sweep_ref_fwd, sweep_ref_bwd)."""
    return tuple(mod.launches for mod, _, _ in KERNELS.values())


def reset_counts():
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    for name in TILES:
        KERNELS[name][0].tiles.reset()
    for kind in light_sweep.launches:
        light_sweep.launches[kind] = 0


# Tile-slices each kernel computed on the main paths, and of those the ones
# read through global memory (a window exceeded the stage the host sized):
# name -> [computed, global].
TILES = {name: [0, 0] for name in ("sweep_fwd", "sweep_bwd",
                                   "sweep_ref_fwd", "sweep_ref_bwd")}
# The light sweep's launches on the main paths, forward and adjoint.
LIGHT_SWEEP = {"forward": 0, "adjoint": 0}


def path_counts(label):
    """counts() at the end of a main path; also takes the tile-slices each
    kernel computed and the light sweep's launches since the last
    reset_counts (or the last call), logs them by path and adds them to
    TILES and LIGHT_SWEEP."""
    launches = counts()
    parts = []
    light = dict(light_sweep.launches)
    for kind, n in light.items():
        LIGHT_SWEEP[kind] += n
        light_sweep.launches[kind] = 0
    if any(light.values()):
        parts.append(f"light_sweep {light['forward']} forward, "
                     f"{light['adjoint']} adjoint launches")
    for name, total in TILES.items():
        tiles = KERNELS[name][0].tiles
        done, glob = tiles.read()
        tiles.reset()
        total[0] += done
        total[1] += glob
        if done:
            parts.append(f"{name} {done} tile-slices, {glob} through global "
                         "memory")
    if parts:
        log(f"tile-slices, {label}: " + "; ".join(parts))
    return launches


def build_all():
    """Build the four kernels' libraries at once: one nvcc each."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        jobs = {name: pool.submit(mod.build_kernel)
                for name, (mod, _, _) in KERNELS.items()}
        return {name: job.result() for name, job in jobs.items()}


def ptxas_report(log_text):
    """(registers of each instantiation, the most spill-store bytes of any)
    from nvcc's -Xptxas -v output."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log_text)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                         log_text)]
    return regs, max(spills, default=0)


def inbox_samples(plan):
    """(samples, lines) of the plan: the samples that lie in front of the
    eye and inside the box, which are the samples a sweep kernel does work
    for when no ray ends early, and the rows plus columns of base pixels
    that hold such a sample, summed over the slices."""
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
    rate. Returns (ms, "operations" or "bytes", flops, bytes)."""
    flops = FLOP_PER_SAMPLE[name] * samples + FLOP_PER_LINE[name] * lines
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def seeded_scroll(seed, dev):
    """A (4, 3) scroll with entries in [-1.5, 1.5]: unlike the preset's
    own, its per-channel offsets are nonzero on every axis."""
    return torch.tensor(np.random.default_rng(seed).uniform(-1.5, 1.5,
                                                            (4, 3)),
                        dtype=torch.float32, device=dev)


def ref_both(grid4, plan, cfg, medium, scroll, rng, autograd=True):
    """The 4-channel kernels and their plain versions on the same inputs:
    the forward maps, and dL on the forward kernel's trans and wsum maps
    and seeded normal cotangents. With `autograd`, also the plain backward
    against autograd of the plain forward. Comparison launches, not the
    main path. Returns (maps, plain maps, dL, plain dL, own, auto)."""
    inputs = sweep_ref_fwd.sweep_ref_inputs(
        grid4.permute(plan.perm + (3,)), plan, cfg, medium, None, scroll)
    em = cfg.emission
    maps = sweep_ref_fwd.launch_kernel(*inputs, em)
    cts = [torch.tensor(rng.normal(size=plan.base_shape),
                        dtype=torch.float32, device=grid4.device)
           for _ in range(3)]
    got = sweep_ref_bwd.launch_kernel(*inputs, *cts, maps[1], maps[2],
                                      emission=em)
    torch.cuda.synchronize()
    want_maps = sweep_ref_fwd.sweep_ref_fwd_reference(*inputs, emission=em)
    want = sweep_ref_bwd.sweep_ref_bwd_reference(*inputs, *cts, maps[1],
                                                 maps[2], emission=em)
    own = auto = None
    if autograd:
        L = inputs[0].detach().clone().requires_grad_()
        fmaps = sweep_ref_fwd.sweep_ref_fwd_reference(L, *inputs[1:],
                                                      emission=em)
        loss = sum((m * c).sum() for m, c in zip(fmaps[:3], cts))
        auto, = torch.autograd.grad(loss, L)
        own = sweep_ref_bwd.sweep_ref_bwd_reference(
            L.detach(), *inputs[1:], *cts, fmaps[1].detach(),
            fmaps[2].detach(), emission=em)
    return maps.unbind(0), want_maps, got, want, own, auto


# Names in a torch.profiler trace of autograd deriving a gradient through
# advanced indexing: index_put_ with accumulate, the sort-based scatter that
# the warp's written-out adjoint (ops/sweep.py _WarpBilinear) replaces.
SCATTER_NAMES = ("indexing_backward_kernel", "IndexBackward",
                 "IndexPutBackward")


def profile_fwdbwd(step, out_dir, name="chip_smoke_profile.txt", n=3):
    """trace_flagship.profile_fwdbwd (torch.profiler over n steps: the
    table in out_dir/name, the device's busy and idle share); fails if the
    steps ran an index_put_ backward (SCATTER_NAMES)."""
    prof = trace_flagship.profile_fwdbwd(step, out_dir, name, n, log=log)
    scatter = sorted(e for e in prof["names"]
                     if any(s in e for s in SCATTER_NAMES))
    if scatter:
        fail(f"{name}: the step ran an index_put_ backward: {scatter}")
    log(f"profile {name}: no index_put_ backward ({', '.join(SCATTER_NAMES)})")


def ref_small_checks(dev):
    """Steps 9: the 4-channel kernels against their plain versions at
    small shapes, and the 4-channel gradient check. Returns the forward
    and backward max abs errors."""
    errs, bwd_errs = [], []
    rng = np.random.default_rng(0)
    small4 = torch.tensor(rng.uniform(0.1, 1.0, (16, 16, 16, 4)),
                          dtype=torch.float32, device=dev)
    scrolls = {"none": None,
               "preset": reference_media_scroll(1.7, device=dev),
               "random": seeded_scroll(REF_SCROLL_SEEDS[0], dev)}
    cases = [(eye, ax, sg, em, kind, None, 1.0)
             for eye, ax, sg in SMALL_EYES for em in (True, False)
             for kind in scrolls]
    cases += [(SMALL_EYES[0][0], 0, -1, em, "random", 24, 1.0)
              for em in (True, False)]
    cases.append((SMALL_EYES[0][0], 0, -1, True, "random", None, 500.0))
    brng = np.random.default_rng(9)
    for eye, axis, sign, emission, kind, n_slices, density in cases:
        cfg = RenderConfig(emission=emission, quadrature="sliced")
        medium = MediumConfig(combine="reference", density=density)
        cam = make_camera(CameraConfig(eye=eye, width=96, height=64))
        plan = plan_for(cam, small4.shape, cfg, n_slices=n_slices,
                        device=dev)
        if (plan.axis, plan.sign) != (axis, sign):
            fail(f"eye {eye}: plan sweeps axis {plan.axis} sign {plan.sign},"
                 f" expected {axis} {sign}")
        what = (f"ref small eye={eye} axis={axis} sign={sign:+d} "
                f"emission={emission} scroll={kind} n_slices={n_slices} "
                f"density={density}")
        maps, want_maps, got, want, own, auto = ref_both(
            small4, plan, cfg, medium, scrolls[kind], brng)
        e = max(check_close(g, w, f"{what} {name}")
                for g, w, name in zip(maps, want_maps,
                                      ("acc", "trans", "wsum", "hit")))
        tol = BWD_TOL_GATE if density > 100.0 else BWD_TOL
        e_bwd, scale = check_grad(got, want, what + " dL", tol)
        e_auto, _ = check_grad(own, auto, what + " (plain vs autograd)", tol)
        if density > 100.0 and not float(maps[1].min()) < 1e-3:
            fail(f"{what}: no ray reached the early-stop gate")
        errs.append(e)
        bwd_errs.append(e_bwd)
        log(f"{what}: maps max abs err {e:.3e}, dL {e_bwd:.3e} (max|dL| "
            f"{scale:.3e}); plain vs autograd {e_auto:.3e}")

    # The gradient check with the 4-channel medium: the kernels' grid
    # gradient on an identity-warp plan against the per-ray oracle's.
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="reference", density=8.0)
    cam = make_camera(CameraConfig(width=48, height=32))
    g24 = torch.tensor(np.random.default_rng(2).uniform(0.1, 1.0,
                                                        (24, 24, 24, 4)),
                       dtype=torch.float32, device=dev)
    scroll = scrolls["random"]
    plan = plan_for(cam, g24.shape, cfg, device=dev)
    o, d = base_rays(plan)
    g1 = g24.clone().requires_grad_()
    (sweep_render(g1, dataclasses.replace(plan, identity_warp=True), cfg,
                  medium, scroll=scroll)[..., :3] ** 2).sum().backward()
    g2 = g24.clone().requires_grad_()
    (render_rays_sliced(g2, o, d, plan, cfg, medium,
                        scroll=scroll)[..., :3] ** 2).sum().backward()
    scale = float(g2.grad.abs().max())
    ok = scale > 0.0 and bool(torch.allclose(g1.grad, g2.grad, rtol=1e-3,
                                             atol=1e-3 * scale))
    log(f"ref grad check: allclose={ok} max_abs_err="
        f"{max_err(g1.grad, g2.grad):.3e} scale={scale:.3e}")
    if not ok:
        fail("4-channel gradient check: the kernels' grid gradient "
             "disagrees with the per-ray oracle's")
    return errs, bwd_errs


def ref_full_width(dev, out_dir):
    """Step 10: the reference preset at full width, serving and training.
    Returns (forward errs, backward errs, serving launches, training
    launches, the grid, the camera and the plan)."""
    errs, bwd_errs = [], []
    t0 = time.perf_counter()
    grid4 = build_volume(VolumeConfig(), device=dev)
    torch.cuda.synchronize()
    log(f"build_volume(VolumeConfig()): {tuple(grid4.shape)} in "
        f"{time.perf_counter() - t0:.2f} s, channel means "
        f"{[round(float(grid4[..., c].mean()), 4) for c in range(4)]}")
    if tuple(grid4.shape) != (REF_VOLUME,) * 3 + (4,):
        fail(f"reference volume shape {tuple(grid4.shape)}")
    cam = make_camera(CameraConfig())
    if (cam.width, cam.height) != (REF_WIDTH, REF_HEIGHT):
        fail(f"reference camera is {cam.width}x{cam.height}")
    medium = MediumConfig()
    scrolls = [(f"reference_media_scroll({t})",
                reference_media_scroll(t, device=dev)) for t in REF_TIMES]
    scrolls += [(f"seeded scroll {seed}", seeded_scroll(seed, dev))
                for seed in REF_SCROLL_SEEDS]
    cfgs = {em: RenderConfig(emission=em, quadrature="sliced")
            for em in (False, True)}
    plan = plan_for(cam, grid4.shape, cfgs[False], device=dev)

    # Serving: eight frames through render_image.
    frames = []
    reset_counts()
    for em, cfg in cfgs.items():
        for name, scroll in scrolls:
            before = sweep_ref_fwd.launches
            img = render_image(grid4, cam, cfg, medium, scroll=scroll,
                               plan=plan)
            torch.cuda.synchronize()
            if sweep_ref_fwd.launches != before + 1:
                fail(f"{name}: render_image launched the 4-channel sweep "
                     f"kernel {sweep_ref_fwd.launches - before} times, "
                     "expected 1")
            frames.append((f"reference emission={em} {name}", cfg, scroll,
                           img))
    serve_launches = path_counts("reference preset serving")
    log(f"reference serving path: {len(frames)} frames, launches (fwd, bwd, "
        f"ref_fwd, ref_bwd) {serve_launches}")
    if serve_launches != (0, 0, len(frames), 0):
        fail(f"reference serving path launched {serve_launches}, expected "
             f"(0, 0, {len(frames)}, 0)")
    for name, cfg, scroll, img in frames:
        if tuple(img.shape) != (REF_HEIGHT, REF_WIDTH, 4):
            fail(f"{name}: image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            fail(f"{name}: non-finite pixels")
        alpha = img[..., 3]
        if float(alpha.min()) < 0.0 or float(alpha.max()) > 1.0:
            fail(f"{name}: alpha outside [0, 1]")
        if float(alpha.max()) <= 0.0 or float(img[..., :3].max()) <= 0.0:
            fail(f"{name}: empty frame (the cube is in view)")
        inputs = sweep_ref_fwd.sweep_ref_inputs(
            grid4.permute(plan.perm + (3,)), plan, cfg, medium, None, scroll)
        got = sweep_ref_fwd.launch_kernel(*inputs, cfg.emission).unbind(0)
        want = sweep_ref_fwd.sweep_ref_fwd_reference(
            *inputs, emission=cfg.emission)
        e = max(check_close(g, w, f"{name} {n}")
                for g, w, n in zip(got, want,
                                   ("acc", "trans", "wsum", "hit")))
        e_img = check_close(img, finish_image(want, plan, cfg, medium),
                            f"{name} image")
        errs += [e, e_img]
        log(f"{name}: maps max abs err {e:.3e}, image {e_img:.3e}, alpha "
            f"mean {float(alpha.mean()):.4f}, rgb mean "
            f"{float(img[..., :3].mean()):.4f}")
    moved = max_err(frames[2][3], frames[0][3])
    if not moved > 1e-3:
        fail("a scroll with nonzero offsets did not move the frame")
    log(f"seeded scroll against t=0: frame differs by {moved:.3e}; "
        f"reference_media_scroll({REF_TIMES[1]}) against t=0: "
        f"{max_err(frames[1][3], frames[0][3]):.3e} (its weighted offsets "
        "are all zero)")
    png = write_png(os.path.join(out_dir, "chip_smoke_reference.png"),
                    frames[2][3])
    log(f"saved {os.path.normpath(png)}")

    # Training: one forward+backward step per mode.
    scroll = scrolls[2][1]
    reset_counts()
    with BackwardSpy(sweep_ref_bwd) as spy:
        for em, cfg in cfgs.items():
            before = counts()
            g = grid4.clone().requires_grad_()
            img = render_image(g, cam, cfg, medium, scroll=scroll, plan=plan)
            loss = (img[..., :3] ** 2).sum()
            loss.backward()
            torch.cuda.synchronize()
            step = tuple(a - b for a, b in zip(counts(), before))
            if step != (0, 0, 1, 1):
                fail(f"reference forward+backward emission={em} launched "
                     f"{step}, expected (0, 0, 1, 1)")
            if not bool(torch.isfinite(g.grad).all()):
                fail(f"reference grid gradient emission={em} is not finite")
            per_channel = [float(g.grad[..., c].abs().max())
                           for c in range(4)]
            if not min(per_channel) > 0.0:
                fail(f"reference grid gradient emission={em} is zero in a "
                     f"channel: max |grad| per channel {per_channel}")
            a, kw, dL = spy.seen[-1]
            want = sweep_ref_bwd.sweep_ref_bwd_reference(*a, **kw)
            e, scale = check_grad(dL, want,
                                  f"reference dL emission={em}")
            bwd_errs.append(e)
            log(f"reference fwd+bwd emission={em}: loss {loss.item():.6e}, "
                f"launches {step}, dL max abs err {e:.3e} at max|dL| "
                f"{scale:.3e}, max |grad| per channel "
                f"{[f'{x:.3e}' for x in per_channel]}")
    train_launches = path_counts("reference preset training")
    log(f"reference training path: launches (fwd, bwd, ref_fwd, ref_bwd) "
        f"{train_launches}")
    if train_launches != (0, 0, 2, 2) or len(spy.seen) != 2:
        fail(f"reference training path launched {train_launches}, expected "
             "(0, 0, 2, 2)")
    return errs, bwd_errs, serve_launches, train_launches, grid4, cam, plan


def ref_timings(grid4, cam, plan, dev, gpu_line, plain_runs=5):
    """Step 11: CUDA-event timings of the 4-channel path on one grid,
    camera and plan, with a seeded scroll (nonzero offsets). Returns the
    emission-mode numbers for the kernel results, the forward+backward
    step function and the bounds' inputs."""
    medium = MediumConfig()
    scroll = seeded_scroll(REF_SCROLL_SEEDS[0], dev)
    gperm4 = grid4.permute(plan.perm + (3,))
    rays = cam.width * cam.height
    samples, lines = inbox_samples(plan)
    S, (Hb, Wb) = plan.slice_z.shape[0], plan.base_shape
    log(f"[{gpu_line}] reference medium {tuple(grid4.shape)} at "
        f"{cam.width}x{cam.height}, base {plan.base_shape}, {S} slices, "
        f"{samples} of {S * Hb * Wb} samples in the box and in front, on "
        f"{lines} rows and columns:")
    out = {}
    for em in (False, True):
        cfg = RenderConfig(emission=em, quadrature="sliced")
        inputs = sweep_ref_fwd.sweep_ref_inputs(gperm4, plan, cfg, medium,
                                                None, scroll)
        maps = sweep_ref_fwd.launch_kernel(*inputs, em)
        cts = [torch.randn(plan.base_shape, device=dev) for _ in range(3)]
        bwd_args = (*inputs, *cts, maps[1], maps[2])
        t = {
            "fwd": cuda_ms(lambda: sweep_ref_fwd.launch_kernel(*inputs, em)),
            "fwd_plain": cuda_ms(
                lambda: sweep_ref_fwd.sweep_ref_fwd_reference(
                    *inputs, emission=em), runs=plain_runs, warmup=1),
            "bwd": cuda_ms(lambda: sweep_ref_bwd.launch_kernel(
                *bwd_args, emission=em)),
            "bwd_plain": cuda_ms(
                lambda: sweep_ref_bwd.sweep_ref_bwd_reference(
                    *bwd_args, emission=em), runs=plain_runs, warmup=1),
            "render": cuda_ms(lambda: render_image(
                grid4, cam, cfg, medium, scroll=scroll, plan=plan)),
        }
        g = grid4.clone().requires_grad_()

        def fwdbwd(g=g, cfg=cfg):
            g.grad = None
            (render_image(g, cam, cfg, medium, scroll=scroll,
                          plan=plan)[..., :3] ** 2).sum().backward()
        t["fwdbwd"] = cuda_ms(fwdbwd)
        min_t = float(maps[1].min())
        log(f"  emission={em}:")
        log(f"    sweep_ref_fwd kernel        {t['fwd']:.3f} ms")
        log(f"    sweep_ref_fwd plain version {t['fwd_plain']:.3f} ms")
        log(f"    sweep_ref_bwd kernel        {t['bwd']:.3f} ms")
        log(f"    sweep_ref_bwd plain version {t['bwd_plain']:.3f} ms")
        log(f"    render_image                {t['render']:.3f} ms = "
            f"{rays / (t['render'] * 1e-3):.4g} forward rays/s (plan "
            "excluded)")
        log(f"    forward+backward step       {t['fwdbwd']:.3f} ms = "
            f"{rays / (t['fwdbwd'] * 1e-3):.4g} fwd+bwd rays/s (plan "
            "excluded)")
        if em:
            measure_warp.warp_timings(maps.unbind(0), plan, cfg, medium,
                                      indent="    ", log=log)
            log(f"    min T {min_t:.4f} against the early-stop threshold "
                f"{cfg.early_stop_transmittance}: "
                + ("no ray ended early, the in-box count is the work done"
                   if min_t > cfg.early_stop_transmittance else
                   "some rays ended early, the in-box count is an upper "
                   "bound of the work done"))
            out = dict(t, fwdbwd_fn=fwdbwd, samples=samples, lines=lines,
                       fwd_tensors=(*inputs, maps),
                       bwd_tensors=(*inputs, *cts[1:], maps[1], maps[2],
                                    inputs[0]))
    # The channel slab build (sweep-axis lerp of the four channels), which
    # runs once per frame because the scroll moves it.
    cfg = RenderConfig(emission=True, quadrature="sliced")
    offs = sweep_ref_fwd._channel_offsets(medium, scroll, plan.coord_order,
                                          device=dev)

    def build(gp):
        return sweep_ref_fwd._layer_channels(gp, plan.slice_z, medium, offs,
                                             cfg.address_mode)
    build_ms = cuda_ms(lambda: build(gperm4))
    gl = grid4.clone().requires_grad_()
    ct = torch.randn_like(build(gperm4))

    def build_fwdbwd():
        gl.grad = None
        build(gl.permute(plan.perm + (3,))).backward(ct)
    build_fb_ms = cuda_ms(build_fwdbwd)
    log(f"  channel slab build forward  {build_ms:.3f} ms")
    log(f"  channel slab build fwd+bwd  {build_fb_ms:.3f} ms (backward "
        f"~{build_fb_ms - build_ms:.3f} ms)")
    return out


def stretched(lvol):
    """A light volume stretched to [-0.2, 1.3]: the clip cuts it on both
    sides, so its subgradient takes all three values."""
    lo = lvol.min()
    out = 1.5 * (lvol - lo) / (1.0 - lo) - 0.2
    if not (float(out.max()) > 1.0 and float(out.min()) < 0.0):
        fail("the stretched light volume does not leave [0, 1]")
    return out


def light_both(grid, lvol, plan, cfg, medium, light, scroll, cts,
               autograd=True):
    """The kernels with a light volume and their plain versions on the
    same inputs, for either medium: the forward maps, and (dG, dL) on the
    forward kernel's trans and wsum maps and the cotangents `cts`. With
    `autograd`, also the plain backward against autograd of the plain
    forward (whose clip is clip_unit). Comparison launches, not the main
    path. Returns (maps, plain maps, grads, plain grads, own, auto)."""
    if medium.combine == "reference":
        inputs = sweep_ref_fwd.sweep_ref_inputs(
            grid.permute(plan.perm + (3,)), plan, cfg, medium, light, scroll)
        lstack = sweep_ref_fwd.sweep_ref_light_slabs(
            lvol.permute(plan.perm), plan, cfg)
        fwd_kw = bwd_kw = dict(emission=True)
        fwd, bwd = sweep_ref_fwd.sweep_ref_fwd_reference, \
            sweep_ref_bwd.sweep_ref_bwd_reference
        maps = sweep_ref_fwd.launch_kernel(*inputs, True, lstack)
        got = sweep_ref_bwd.launch_kernel(*inputs, *cts, maps[1], maps[2],
                                          emission=True, light=lstack)
    else:
        (stack, *args), flip = sweep_fwd.sweep_inputs(
            grid.permute(plan.perm), plan, cfg, medium, light)
        inputs = (stack.contiguous(), *args)
        lstack = sweep_fwd.sweep_light_stack(lvol.permute(plan.perm), plan,
                                             cfg).contiguous()
        wrap = cfg.address_mode == "wrap"
        fwd_kw = bwd_kw = dict(emission=True, flip=flip,
                               address_mode=cfg.address_mode)
        fwd, bwd = sweep_fwd.sweep_fwd_reference, \
            sweep_bwd.sweep_bwd_reference
        maps = sweep_fwd.launch_kernel(*inputs, True, flip, wrap, lstack)
        got = sweep_bwd.launch_kernel(*inputs, *cts, maps[1], maps[2], True,
                                      flip, wrap, light=lstack)
    torch.cuda.synchronize()
    want_maps = fwd(*inputs, light=lstack, **fwd_kw)
    want = bwd(*inputs, *cts, maps[1], maps[2], light=lstack, **bwd_kw)
    own = auto = None
    if autograd:
        L = inputs[0].detach().clone().requires_grad_()
        lt = lstack.detach().clone().requires_grad_()
        fmaps = fwd(L, *inputs[1:], light=lt, **fwd_kw)
        loss = sum((m * c).sum() for m, c in zip(fmaps[:3], cts))
        auto = torch.autograd.grad(loss, (L, lt))
        own = bwd(L.detach(), *inputs[1:], *cts, fmaps[1].detach(),
                  fmaps[2].detach(), light=lt.detach(), **bwd_kw)
    return maps.unbind(0), want_maps, got, want, own, auto


def check_light_case(what, result, tol=BWD_TOL):
    """Holds one light_both result to the tolerances; returns the maps'
    and the gradients' max abs errors."""
    maps, want_maps, got, want, own, auto = result
    e = max(check_close(g, w, f"{what} {name}")
            for g, w, name in zip(maps, want_maps,
                                  ("acc", "trans", "wsum", "hit")))
    e_g, s_g = check_grad(got[0], want[0], what + " dG", tol)
    e_l, s_l = check_grad(got[1], want[1], what + " dL", tol)
    msg = (f"{what}: maps max abs err {e:.3e}, dG {e_g:.3e} (max {s_g:.3e}),"
           f" dL {e_l:.3e} (max {s_l:.3e})")
    if own is not None:
        a_g, _ = check_grad(own[0], auto[0],
                            what + " dG (plain vs autograd)", tol)
        a_l, _ = check_grad(own[1], auto[1],
                            what + " dL (plain vs autograd)", tol)
        msg += f"; plain vs autograd {a_g:.3e}, {a_l:.3e}"
    log(msg)
    return e, max(e_g, e_l)


def light_small_checks(dev):
    """Step 12: the light branch of the four kernels at small shapes and
    the gradient checks with shadows. Returns {kernel: [errors]}."""
    errs = {name: [] for name in KERNELS}
    light = LightConfig(ambient=0.2, shadow_steps=32)
    rng = np.random.default_rng(0)
    small = torch.tensor(rng.uniform(0.2, 1.0, (16, 16, 16)),
                         dtype=torch.float32, device=dev)
    small4 = torch.tensor(rng.uniform(0.1, 1.0, (16, 16, 16, 4)),
                          dtype=torch.float32, device=dev)
    scroll = seeded_scroll(REF_SCROLL_SEEDS[0], dev)
    # (combine, eye, axis, sign, address mode, light kind, n_slices, density)
    cases = [("single", eye, ax, sg, mode, kind, None, 8.0)
             for eye, ax, sg in SMALL_EYES for mode in ("mirror", "wrap")
             for kind in ("ones", "stretched")]
    cases += [("single", SMALL_EYES[0][0], 0, -1, "mirror", kind, 24, 8.0)
              for kind in ("ones", "stretched")]
    cases.append(("single", SMALL_EYES[0][0], 0, -1, "mirror", "ones", None,
                  500.0))
    cases += [("reference", eye, ax, sg, "mirror", kind, None, 8.0)
              for eye, ax, sg in SMALL_EYES for kind in ("ones", "stretched")]
    cases.append(("reference", SMALL_EYES[0][0], 0, -1, "mirror",
                  "stretched", 24, 8.0))
    cases.append(("reference", SMALL_EYES[0][0], 0, -1, "mirror", "ones",
                  None, 500.0))
    brng = np.random.default_rng(9)
    for combine, eye, axis, sign, mode, kind, n_slices, density in cases:
        ref = combine == "reference"
        grid, sc = (small4, scroll) if ref else (small, None)
        cfg = RenderConfig(emission=True, quadrature="sliced",
                           address_mode=mode)
        medium = MediumConfig(combine=combine, density=density)
        cam = make_camera(CameraConfig(eye=eye, width=96, height=64))
        plan = plan_for(cam, grid.shape, cfg, n_slices=n_slices, device=dev)
        if (plan.axis, plan.sign) != (axis, sign):
            fail(f"eye {eye}: plan sweeps axis {plan.axis} sign {plan.sign},"
                 f" expected {axis} {sign}")
        lvol = light_transmittance_volume(grid, light, cfg, medium,
                                          scroll=sc)
        if not float((lvol == 1.0).float().mean()) > 0.02:
            fail("the light volume has no fully lit voxels (exact ones)")
        if kind == "stretched":
            lvol = stretched(lvol)
        cts = [torch.tensor(brng.normal(size=plan.base_shape),
                            dtype=torch.float32, device=dev)
               for _ in range(3)]
        what = (f"light small {combine} eye={eye} axis={axis} "
                f"sign={sign:+d} {mode} light={kind} n_slices={n_slices} "
                f"density={density}")
        result = light_both(grid, lvol, plan, cfg, medium, light, sc, cts)
        if density > 100.0 and not float(result[0][1].min()) < 1e-3:
            fail(f"{what}: no ray reached the early-stop gate")
        e, e_bwd = check_light_case(
            what, result, BWD_TOL_GATE if density > 100.0 else BWD_TOL)
        errs["sweep_ref_fwd" if ref else "sweep_fwd"].append(e)
        errs["sweep_ref_bwd" if ref else "sweep_bwd"].append(e_bwd)

    # bench.py's gradient check with shadows: the light volume is built
    # from the grid inside the loss, so the gradient reaches the grid
    # through dG and through dL and the light sweep.
    cfg = RenderConfig(emission=True, quadrature="sliced")
    cam = make_camera(CameraConfig(width=48, height=32))
    g24x4 = torch.tensor(np.random.default_rng(2).uniform(
        0.1, 1.0, (24, 24, 24, 4)), dtype=torch.float32, device=dev)
    for name, g24, medium, sc in (
            ("single-channel", cloud_volume(24, 7, device=dev),
             MediumConfig(combine="single", density=8.0), None),
            ("4-channel", g24x4, MediumConfig(density=8.0), scroll)):
        plan = plan_for(cam, g24.shape, cfg, device=dev)
        o, d = base_rays(plan)

        def lvol_of(g, medium=medium, sc=sc):
            return light_transmittance_volume(g, CONFIG4_LIGHT, cfg, medium,
                                              scroll=sc)
        g1 = g24.clone().requires_grad_()
        (sweep_render(g1, dataclasses.replace(plan, identity_warp=True), cfg,
                      medium, CONFIG4_LIGHT, scroll=sc,
                      light_volume=lvol_of(g1))[..., :3] ** 2).sum() \
            .backward()
        g2 = g24.clone().requires_grad_()
        (render_rays_sliced(g2, o, d, plan, cfg, medium, CONFIG4_LIGHT,
                            scroll=sc,
                            light_volume=lvol_of(g2))[..., :3] ** 2).sum() \
            .backward()
        scale = float(g2.grad.abs().max())
        ok = scale > 0.0 and bool(torch.allclose(g1.grad, g2.grad, rtol=1e-3,
                                                 atol=1e-3 * scale))
        log(f"grad check with shadows, {name}: allclose={ok} max_abs_err="
            f"{max_err(g1.grad, g2.grad):.3e} scale={scale:.3e}")
        if not ok:
            fail(f"{name} gradient check with shadows: the kernels' grid "
                 "gradient disagrees with the per-ray oracle's")
    return errs


def shadow_frame_checks(name, img, lit):
    """A shadowed frame against the unshadowed one (tests/test_lighting.py):
    finite, alpha in [0, 1] and unchanged, rgb nowhere brighter and
    somewhere darker. Returns the largest darkening."""
    if img.shape != lit.shape or not bool(torch.isfinite(img).all()):
        fail(f"{name}: shape {tuple(img.shape)} or non-finite pixels")
    alpha = img[..., 3]
    if float(alpha.min()) < 0.0 or float(alpha.max()) > 1.0 \
            or float(alpha.max()) <= 0.0:
        fail(f"{name}: alpha outside [0, 1] or an empty frame")
    if max_err(alpha, lit[..., 3]) > 1e-6:
        fail(f"{name}: shadows changed alpha by "
             f"{max_err(alpha, lit[..., 3]):.3e}")
    if not bool((img[..., :3] <= lit[..., :3] + 1e-6).all()):
        fail(f"{name}: a shadowed pixel is brighter than the unshadowed one")
    dark = float((lit[..., :3] - img[..., :3]).max())
    if not dark > 1e-3:
        fail(f"{name}: the shadows darkened nothing (max {dark:.3e})")
    return dark


def config4_full_width(grid, dev, out_dir):
    """Step 13: config 4 at full width, serving and training. Returns
    ({kernel: [errors]}, serving launches, training launches, and what the
    timings reuse: the first frame's camera and plan)."""
    errs = {name: [] for name in KERNELS}
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    light = CONFIG4_LIGHT
    cams = [orbit_camera(2.0 * math.pi * i / CONFIG4_FRAMES, width=WIDTH,
                         height=HEIGHT) for i in range(CONFIG4_FRAMES)]
    plans = [plan_for(cam, grid.shape, cfg, device=dev) for cam in cams]

    # Serving: the light volume is rebuilt by render_image in every frame.
    frames = []
    reset_counts()
    for i, (cam, plan) in enumerate(zip(cams, plans)):
        before = (sweep_fwd.launches, dict(light_sweep.launches))
        img = render_image(grid, cam, cfg, medium, light, plan=plan)
        torch.cuda.synchronize()
        if sweep_fwd.launches != before[0] + 1:
            fail(f"config 4 frame {i}: render_image launched the sweep "
                 f"kernel {sweep_fwd.launches - before[0]} times, expected 1")
        if light_sweep.launches != {"forward": before[1]["forward"] + 1,
                                    "adjoint": before[1]["adjoint"]}:
            fail(f"config 4 frame {i}: the light sweep's launches went from "
                 f"{before[1]} to {light_sweep.launches}, expected one "
                 "forward")
        frames.append(img)
    serve_launches = path_counts("config 4 serving")
    log(f"config 4 serving path: {len(frames)} shadowed frames, launches "
        f"(fwd, bwd, ref_fwd, ref_bwd) {serve_launches}")
    if serve_launches != (len(frames), 0, 0, 0):
        fail(f"config 4 serving path launched {serve_launches}, expected "
             f"({len(frames)}, 0, 0, 0)")
    sectors = {(p.axis, p.sign) for p in plans}
    if not {(0, -1), (0, 1), (1, -1), (1, 1)} <= sectors \
            or 2 not in {a for a, _ in sectors}:
        fail(f"the orbit did not cross every sector: {sorted(sectors)}")
    lvol = light_transmittance_volume(grid, light, cfg, medium)
    if tuple(lvol.shape) != tuple(grid.shape) or float(lvol.max()) != 1.0 \
            or float(lvol.min()) < 0.0:
        fail("the config 4 light volume is not a (D, H, W) transmittance")
    log(f"config 4 light volume: min {float(lvol.min()):.4f}, mean "
        f"{float(lvol.mean()):.4f}, share exactly 1.0 "
        f"{float((lvol == 1.0).float().mean()):.4f}")
    held = {}  # sign -> frame index whose base maps are held to plain
    for i, plan in enumerate(plans):
        held.setdefault(plan.sign, i)
    for i, (cam, plan, img) in enumerate(zip(cams, plans, frames)):
        name = f"config 4 frame {i}"
        if tuple(img.shape) != (HEIGHT, WIDTH, 4):
            fail(f"{name}: image shape {tuple(img.shape)}")
        lit = render_image(grid, cam, cfg, medium, plan=plan)
        dark = shadow_frame_checks(name, img, lit)
        msg = (f"{name}: axis={plan.axis} sign={plan.sign:+d} base "
               f"{plan.base_shape}; alpha mean "
               f"{float(img[..., 3].mean()):.4f}, rgb mean "
               f"{float(img[..., :3].mean()):.4f} against "
               f"{float(lit[..., :3].mean()):.4f} unshadowed, darkest by "
               f"{dark:.4f}")
        if i in held.values():
            (stack, *args), flip = sweep_fwd.sweep_inputs(
                grid.permute(plan.perm), plan, cfg, medium, light)
            stack = stack.contiguous()
            lstack = sweep_fwd.sweep_light_stack(lvol.permute(plan.perm),
                                                 plan, cfg).contiguous()
            got = sweep_fwd.launch_kernel(stack, *args, True, flip, False,
                                          lstack).unbind(0)
            want = sweep_fwd.sweep_fwd_reference(
                stack, *args, emission=True, flip=flip,
                address_mode=cfg.address_mode, light=lstack)
            e = max(check_close(g, w, f"{name} {n}")
                    for g, w, n in zip(got, want,
                                       ("acc", "trans", "wsum", "hit")))
            e_img = check_close(img, finish_image(want, plan, cfg, medium,
                                                  light), f"{name} image")
            errs["sweep_fwd"] += [e, e_img]
            msg += f"; maps max abs err {e:.3e}, image {e_img:.3e}"
        log(msg)
    png = write_png(os.path.join(out_dir, "chip_smoke_config4.png"),
                    frames[1])
    log(f"saved {os.path.normpath(png)}")

    # Training: one forward+backward step; the gradient reaches the grid
    # through dG and through dL and the light sweep.
    cam, plan = cams[0], plans[0]
    reset_counts()
    g = grid.clone().requires_grad_()
    before = dict(light_sweep.launches)
    with BackwardSpy(sweep_bwd) as spy:
        img = render_image(g, cam, cfg, medium, light, plan=plan)
        loss = (img[..., :3] ** 2).sum()
        loss.backward()
        torch.cuda.synchronize()
    if light_sweep.launches != {k: v + 1 for k, v in before.items()}:
        fail(f"config 4 forward+backward: the light sweep's launches went "
             f"from {before} to {light_sweep.launches}, expected one "
             "forward and one adjoint")
    train_launches = path_counts("config 4 training")
    if train_launches != (1, 1, 0, 0) or len(spy.seen) != 1:
        fail(f"config 4 forward+backward launched {train_launches}, "
             "expected (1, 1, 0, 0)")
    a, kw, (dG, dL) = spy.seen[0]
    want_g, want_l = sweep_bwd.sweep_bwd_reference(
        *a[:11], emission=a[11], flip=a[12], address_mode=cfg.address_mode,
        **kw)
    e_g, s_g = check_grad(dG, want_g, "config 4 dG")
    e_l, s_l = check_grad(dL, want_l, "config 4 dL")
    errs["sweep_bwd"] += [e_g, e_l]
    g0 = grid.clone().requires_grad_()
    (render_image(g0, cam, cfg, medium, plan=plan)[..., :3] ** 2).sum() \
        .backward()
    moved = max_err(g.grad, g0.grad)
    if not bool(torch.isfinite(g.grad).all()) \
            or not moved > 1e-3 * float(g0.grad.abs().max()):
        fail("config 4 grid gradient is not finite, or equals the "
             f"unshadowed step's (differs by {moved:.3e})")
    log(f"config 4 fwd+bwd: loss {loss.item():.6e}, launches "
        f"{train_launches}, dG max abs err {e_g:.3e} at max {s_g:.3e}, dL "
        f"{e_l:.3e} at max {s_l:.3e}; grid gradient max "
        f"{float(g.grad.abs().max()):.3e}, differs from the unshadowed "
        f"step's (max {float(g0.grad.abs().max()):.3e}) by {moved:.3e}")
    return errs, serve_launches, train_launches, cam, plan


def ref_shadow_full_width(grid4, cam, plan, dev):
    """Step 14: the reference medium with shadows at the preset's width:
    two frames and one forward+backward step through K4 and K5's light
    branch. Returns ({kernel: [errors]}, serving launches, training
    launches)."""
    errs = {name: [] for name in KERNELS}
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium, light = REF_SHADOW_MEDIUM, CONFIG4_LIGHT
    scrolls = [seeded_scroll(seed, dev) for seed in REF_SCROLL_SEEDS]

    def both(scroll, cts):
        lvol = light_transmittance_volume(grid4, light, cfg, medium,
                                          scroll=scroll)
        return light_both(grid4, lvol, plan, cfg, medium, light, scroll, cts,
                          autograd=False)

    reset_counts()
    frames = []
    for scroll in scrolls:
        frames.append(render_image(grid4, cam, cfg, medium, light,
                                   scroll=scroll, plan=plan))
        torch.cuda.synchronize()
    serve_launches = path_counts("reference medium with shadows serving")
    if serve_launches != (0, 0, len(frames), 0):
        fail(f"reference shadowed serving launched {serve_launches}, "
             f"expected (0, 0, {len(frames)}, 0)")
    cts = [torch.randn(plan.base_shape, device=dev) for _ in range(3)]
    for k, (scroll, img) in enumerate(zip(scrolls, frames)):
        name = f"reference shadowed frame {k}"
        lit = render_image(grid4, cam, cfg, medium, scroll=scroll, plan=plan)
        dark = shadow_frame_checks(name, img, lit)
        maps, want_maps, got, want, _, _ = both(scroll, cts)
        e = max(check_close(g, w, f"{name} {n}")
                for g, w, n in zip(maps, want_maps,
                                   ("acc", "trans", "wsum", "hit")))
        e_img = check_close(img, finish_image(want_maps, plan, cfg, medium,
                                              light), f"{name} image")
        errs["sweep_ref_fwd"] += [e, e_img]
        log(f"{name}: maps max abs err {e:.3e}, image {e_img:.3e}, rgb mean "
            f"{float(img[..., :3].mean()):.4f} against "
            f"{float(lit[..., :3].mean()):.4f} unshadowed, darkest by "
            f"{dark:.4f}")

    reset_counts()
    g = grid4.clone().requires_grad_()
    with BackwardSpy(sweep_ref_bwd) as spy:
        img = render_image(g, cam, cfg, medium, light, scroll=scrolls[0],
                           plan=plan)
        loss = (img[..., :3] ** 2).sum()
        loss.backward()
        torch.cuda.synchronize()
    train_launches = path_counts("reference medium with shadows training")
    if train_launches != (0, 0, 1, 1) or len(spy.seen) != 1:
        fail(f"reference shadowed forward+backward launched "
             f"{train_launches}, expected (0, 0, 1, 1)")
    a, kw, (dLc, dLl) = spy.seen[0]
    want_c, want_l = sweep_ref_bwd.sweep_ref_bwd_reference(*a, **kw)
    e_c, s_c = check_grad(dLc, want_c, "reference shadowed dL (channels)")
    e_l, s_l = check_grad(dLl, want_l, "reference shadowed dL (light)")
    errs["sweep_ref_bwd"] += [e_c, e_l]
    per_channel = [float(g.grad[..., c].abs().max()) for c in range(4)]
    if not bool(torch.isfinite(g.grad).all()) or not min(per_channel) > 0.0:
        fail("reference shadowed grid gradient is not finite and nonzero in "
             f"every channel: {per_channel}")
    log(f"reference shadowed fwd+bwd: loss {loss.item():.6e}, launches "
        f"{train_launches}, channel-slab dL max abs err {e_c:.3e} at max "
        f"{s_c:.3e}, light-slab dL {e_l:.3e} at max {s_l:.3e}")
    return errs, serve_launches, train_launches


def light_sweep_timings(grid, light, cfg, medium, gpu_line):
    """Step 15, the light sweep's kernel at config 4: the forward held bit
    for bit to its plain version; the adjoint, on the forward's L and a
    seeded cotangent, held to the adjoint's plain version and to autograd
    through the forward's plain version; each timed beside its bound, and
    the plain version timed as a yardstick. Returns {"ms", "adjoint_ms",
    "plain_ms", "bound_ms", "bound_ms_adjoint", "max_abs_err"}."""
    sigma = grid * medium.sample_scale
    perm, sweep = light_sweep_geometry(light, cfg, medium,
                                       tuple(sigma.shape))
    sigma = sigma.permute(perm).contiguous()
    dL = torch.randn(sigma.shape, device=sigma.device,
                     generator=torch.Generator(sigma.device).manual_seed(5))
    got = light_sweep.launch_kernel(sigma, sweep)
    want = light_sweep.light_sweep_reference(sigma, sweep)
    if not torch.equal(got, want):
        fail("light sweep kernel differs from its plain version: max abs "
             f"{max_err(got, want):.3e}")
    dsigma = light_sweep.launch_kernel(got, sweep, aux=dL)
    s_ref = sigma.clone().requires_grad_()
    light_sweep.light_sweep_reference(s_ref, sweep).backward(dL)
    errs = []
    for name, g_want in (
            ("the adjoint's plain version",
             light_sweep.light_sweep_adjoint_reference(got, dL, sweep)),
            ("autograd through the plain version", s_ref.grad)):
        e, scale = check_grad(dsigma, g_want,
                              f"light sweep adjoint kernel against {name}")
        errs.append(e)
    t = {"ms": cuda_ms(lambda: light_sweep.launch_kernel(sigma, sweep)),
         "adjoint_ms": cuda_ms(lambda: light_sweep.launch_kernel(
             got, sweep, aux=dL)),
         "plain_ms": cuda_ms(lambda: light_sweep.light_sweep_reference(
             sigma, sweep), runs=3, warmup=1),
         # Read sigma once and write L once, at 3.35 TB/s.
         "bound_ms": 2 * sigma.numel() * 4 / PEAK_BYTES * 1e3,
         # Read L and dL once and write the gradient once.
         "bound_ms_adjoint": 3 * sigma.numel() * 4 / PEAK_BYTES * 1e3,
         "max_abs_err": max(errs)}
    log(f"[{gpu_line}] light sweep kernel at config 4 "
        f"{tuple(sigma.shape)}: forward {t['ms']:.3f} ms against a bound "
        f"of {t['bound_ms']:.4f} ms (share {t['bound_ms'] / t['ms']:.4f}; "
        f"bytes: sigma read and L written once), equal to its plain version "
        f"bit for bit; adjoint {t['adjoint_ms']:.3f} ms against a bound of "
        f"{t['bound_ms_adjoint']:.4f} ms (share "
        f"{t['bound_ms_adjoint'] / t['adjoint_ms']:.4f}; bytes: L and dL "
        f"read, the gradient written once), max abs err {errs[0]:.3e} "
        f"against the adjoint's plain version and {errs[1]:.3e} against "
        f"autograd at max {scale:.3e}; plain version {t['plain_ms']:.3f} ms")
    return t


def light_timings(grid, cam, plan, grid4, cam4, plan4, dev, gpu_line,
                  out_dir):
    """Step 15: CUDA-event timings of the shadowed paths. Returns
    {kernel: (ms, plain ms, samples, lines, tensors)} for the light
    variants."""
    cfg = RenderConfig(emission=True, quadrature="sliced")
    light = CONFIG4_LIGHT
    out = {}

    # Config 4: the light sweep, K1 and K2 with light, frame and step.
    medium = MediumConfig(combine="single", density=8.0)
    out["light_sweep"] = light_sweep_timings(grid, light, cfg, medium,
                                             gpu_line)
    sweep_ms = cuda_ms(lambda: light_transmittance_volume(grid, light, cfg,
                                                          medium), runs=6)
    gl = grid.clone().requires_grad_()
    ct = torch.randn_like(grid)

    def sweep_fwdbwd():
        gl.grad = None
        light_transmittance_volume(gl, light, cfg, medium).backward(ct)
    sweep_fb_ms = cuda_ms(sweep_fwdbwd, runs=6)
    lvol = light_transmittance_volume(grid, light, cfg, medium)
    (stack, *args), flip = sweep_fwd.sweep_inputs(grid.permute(plan.perm),
                                                  plan, cfg, medium, light)
    stack = stack.contiguous()
    lstack = sweep_fwd.sweep_light_stack(lvol.permute(plan.perm), plan,
                                         cfg).contiguous()
    maps = sweep_fwd.launch_kernel(stack, *args, True, flip, False, lstack)
    cts = [torch.randn(plan.base_shape, device=dev) for _ in range(3)]
    kw = dict(emission=True, flip=flip, address_mode=cfg.address_mode,
              light=lstack)
    t = {
        "fwd": cuda_ms(lambda: sweep_fwd.launch_kernel(
            stack, *args, True, flip, False, lstack)),
        "fwd_nolight": cuda_ms(lambda: sweep_fwd.launch_kernel(
            stack, *args, True, flip, False)),
        "fwd_plain": cuda_ms(lambda: sweep_fwd.sweep_fwd_reference(
            stack, *args, **kw), runs=3, warmup=1),
        "bwd": cuda_ms(lambda: sweep_bwd.launch_kernel(
            stack, *args, *cts, maps[1], maps[2], True, flip, False,
            light=lstack)),
        "bwd_nolight": cuda_ms(lambda: sweep_bwd.launch_kernel(
            stack, *args, *cts, maps[1], maps[2], True, flip, False)),
        "bwd_plain": cuda_ms(lambda: sweep_bwd.sweep_bwd_reference(
            stack, *args, *cts, maps[1], maps[2], **kw), runs=3, warmup=1),
        "render": cuda_ms(lambda: render_image(grid, cam, cfg, medium, light,
                                               plan=plan)),
        "render_nolight": cuda_ms(lambda: render_image(grid, cam, cfg,
                                                       medium, plan=plan)),
    }
    g = grid.clone().requires_grad_()

    def fwdbwd():
        g.grad = None
        (render_image(g, cam, cfg, medium, light,
                      plan=plan)[..., :3] ** 2).sum().backward()
    t["fwdbwd"] = cuda_ms(fwdbwd, runs=6)
    rays = cam.width * cam.height
    samples, lines = inbox_samples(plan)
    min_t = float(maps[1].min())
    log(f"[{gpu_line}] config 4: {tuple(grid.shape)} at {cam.width}x"
        f"{cam.height}, orbit frame 0 (axis {plan.axis}, sign "
        f"{plan.sign:+d}), base {plan.base_shape}, "
        f"{plan.slice_z.shape[0]} slices, {samples} samples in the box and "
        f"in front on {lines} rows and columns, min T {min_t:.4f}"
        + ("" if min_t > cfg.early_stop_transmittance else
           " (some rays ended early: the in-box count is an upper bound)")
        + ":")
    log(f"  light_transmittance_volume forward   {sweep_ms:.3f} ms")
    log(f"  light_transmittance_volume fwd+bwd   {sweep_fb_ms:.3f} ms")
    log(f"  sweep_fwd kernel with light          {t['fwd']:.3f} ms "
        f"(without, same plan: {t['fwd_nolight']:.3f} ms)")
    log(f"  sweep_fwd plain version with light   {t['fwd_plain']:.3f} ms")
    log(f"  sweep_bwd kernel with light          {t['bwd']:.3f} ms "
        f"(without, same plan: {t['bwd_nolight']:.3f} ms)")
    log(f"  sweep_bwd plain version with light   {t['bwd_plain']:.3f} ms")
    log(f"  render_image with shadows            {t['render']:.3f} ms = "
        f"{rays / (t['render'] * 1e-3):.4g} forward rays/s (plan reused, "
        f"light volume rebuilt; unshadowed {t['render_nolight']:.3f} ms)")
    log(f"  shadowed forward+backward step       {t['fwdbwd']:.3f} ms = "
        f"{rays / (t['fwdbwd'] * 1e-3):.4g} fwd+bwd rays/s")
    measure_warp.warp_timings(maps.unbind(0), plan, cfg, medium, light,
                              log=log)
    profile_fwdbwd(fwdbwd, out_dir, "chip_smoke_profile_config4.txt")
    base = (stack, *args)
    out["sweep_fwd"] = (t["fwd"], t["fwd_plain"], samples, lines,
                        (*base, lstack, maps))
    out["sweep_bwd"] = (t["bwd"], t["bwd_plain"], samples, lines,
                        (*base, lstack, *cts[1:], maps[1], maps[2], stack,
                         lstack))

    # The reference medium with shadows at the preset.
    medium = REF_SHADOW_MEDIUM
    scroll = seeded_scroll(REF_SCROLL_SEEDS[0], dev)
    mat_ms = cuda_ms(lambda: materialize_sigma(grid4, medium, scroll))
    sweep4_ms = cuda_ms(lambda: light_transmittance_volume(
        grid4, light, cfg, medium, scroll=scroll), runs=6)
    lvol = light_transmittance_volume(grid4, light, cfg, medium,
                                      scroll=scroll)
    inputs = sweep_ref_fwd.sweep_ref_inputs(
        grid4.permute(plan4.perm + (3,)), plan4, cfg, medium, light, scroll)
    lslabs = sweep_ref_fwd.sweep_ref_light_slabs(lvol.permute(plan4.perm),
                                                 plan4, cfg)
    slab_ms = cuda_ms(lambda: sweep_ref_fwd.sweep_ref_light_slabs(
        lvol.permute(plan4.perm), plan4, cfg))
    maps = sweep_ref_fwd.launch_kernel(*inputs, True, lslabs)
    cts = [torch.randn(plan4.base_shape, device=dev) for _ in range(3)]
    bwd_args = (*inputs, *cts, maps[1], maps[2])
    t = {
        "fwd": cuda_ms(lambda: sweep_ref_fwd.launch_kernel(*inputs, True,
                                                           lslabs)),
        "fwd_nolight": cuda_ms(lambda: sweep_ref_fwd.launch_kernel(*inputs,
                                                                   True)),
        "fwd_plain": cuda_ms(lambda: sweep_ref_fwd.sweep_ref_fwd_reference(
            *inputs, emission=True, light=lslabs), runs=3, warmup=1),
        "bwd": cuda_ms(lambda: sweep_ref_bwd.launch_kernel(
            *bwd_args, emission=True, light=lslabs)),
        "bwd_nolight": cuda_ms(lambda: sweep_ref_bwd.launch_kernel(
            *bwd_args, emission=True)),
        "bwd_plain": cuda_ms(lambda: sweep_ref_bwd.sweep_ref_bwd_reference(
            *bwd_args, emission=True, light=lslabs), runs=3, warmup=1),
        "render": cuda_ms(lambda: render_image(
            grid4, cam4, cfg, medium, light, scroll=scroll, plan=plan4)),
    }
    g4 = grid4.clone().requires_grad_()

    def fwdbwd4():
        g4.grad = None
        (render_image(g4, cam4, cfg, medium, light, scroll=scroll,
                      plan=plan4)[..., :3] ** 2).sum().backward()
    t["fwdbwd"] = cuda_ms(fwdbwd4, runs=6)
    rays = cam4.width * cam4.height
    samples, lines = inbox_samples(plan4)
    log(f"[{gpu_line}] reference medium with shadows, density "
        f"{medium.density}: {tuple(grid4.shape)} "
        f"at {cam4.width}x{cam4.height}, base {plan4.base_shape}, "
        f"{plan4.slice_z.shape[0]} slices, {samples} samples in the box and "
        f"in front, min T {float(maps[1].min()):.4f}:")
    log(f"  materialize_sigma                    {mat_ms:.3f} ms")
    log(f"  light_transmittance_volume forward   {sweep4_ms:.3f} ms "
        "(materialize_sigma included)")
    log(f"  light slab lerp                      {slab_ms:.3f} ms")
    log(f"  sweep_ref_fwd kernel with light      {t['fwd']:.3f} ms "
        f"(without: {t['fwd_nolight']:.3f} ms)")
    log(f"  sweep_ref_fwd plain with light       {t['fwd_plain']:.3f} ms")
    log(f"  sweep_ref_bwd kernel with light      {t['bwd']:.3f} ms "
        f"(without: {t['bwd_nolight']:.3f} ms)")
    log(f"  sweep_ref_bwd plain with light       {t['bwd_plain']:.3f} ms")
    log(f"  render_image with shadows            {t['render']:.3f} ms = "
        f"{rays / (t['render'] * 1e-3):.4g} forward rays/s")
    log(f"  shadowed forward+backward step       {t['fwdbwd']:.3f} ms = "
        f"{rays / (t['fwdbwd'] * 1e-3):.4g} fwd+bwd rays/s")
    out["sweep_ref_fwd"] = (t["fwd"], t["fwd_plain"], samples, lines,
                            (*inputs, lslabs, maps))
    out["sweep_ref_bwd"] = (t["bwd"], t["bwd_plain"], samples, lines,
                            (*inputs, lslabs, *cts[1:], maps[1], maps[2],
                             inputs[0], lslabs))
    return out


# --- the tiled schedule of K1 and K2 (kernels/csrc/sweep_tile.cuh) --------
#
# Each case runs K1 and K2 with the stage the host sizes from the plan, with
# none (every tile-slice through global memory) and with half of it (both
# paths in one launch); K1's maps are equal bit for bit across the three
# and, like K2's gradients, held to the plain versions at the tolerances of
# the phases above.
TILED_STRESS = (
    ("wrap seam", dict(eye=(0.9, 0.8, 1.6), mode="wrap", light="ones")),
    ("ragged base 100x70", dict(eye=SMALL_EYES[1][0], force=(100, 70))),
    ("ragged base 70x100, absorption, clamp",
     dict(eye=SMALL_EYES[2][0], emission=False, mode="clamp",
          force=(70, 100))),
    ("density 500", dict(eye=SMALL_EYES[0][0], density=500.0)),
    ("light with lT exactly 1", dict(eye=SMALL_EYES[3][0], light="ones")),
    ("light stretched, wrap", dict(eye=SMALL_EYES[2][0], light="stretched",
                                   mode="wrap")),
    ("bfloat16 with light, wrap seam",
     dict(eye=(0.9, 0.8, 1.6), mode="wrap", light="ones", low=True)),
    ("texels denser than pixels, 64^3 on 37x45",
     dict(eye=SMALL_EYES[3][0], size=64, force=(37, 45))),
    ("stage above 48 KB, 128^3 on 56x56",
     dict(eye=SMALL_EYES[3][0], size=128, force=(56, 56))),
)


def tiled_stress_checks(dev):
    """The stress cases of K1's and K2's tiled schedule (TILED_STRESS).
    Returns {kernel: [errors]}."""
    from volumetricrenderer_tpu_torch.kernels import build
    from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep
    errs = {"sweep_fwd": [], "sweep_bwd": []}
    lcfg = LightConfig(ambient=0.2, shadow_steps=32)
    for what, case in TILED_STRESS:
        em, mode = case.get("emission", True), case.get("mode", "mirror")
        n = case.get("size", 16)
        grid = torch.tensor(np.random.default_rng(0).uniform(0.2, 1.0,
                                                             (n,) * 3),
                            dtype=torch.float32, device=dev)
        cfg = RenderConfig(emission=em, quadrature="sliced",
                           address_mode=mode)
        plan = plan_sweep(make_camera(CameraConfig(eye=case["eye"], width=96,
                                                   height=64)),
                          grid.shape, cfg, supersample=cfg.sweep_supersample,
                          force_base_dims=case.get("force"), device=dev)
        medium = MediumConfig(combine="single",
                              density=case.get("density", 8.0))
        kind = case.get("light")
        (stack, *args), flip = sweep_fwd.sweep_inputs(
            grid.permute(plan.perm), plan, cfg, medium,
            lcfg if kind else None)
        stack, light = stack.contiguous(), None
        if kind:
            lvol = light_transmittance_volume(grid, lcfg, cfg, medium)
            if kind == "stretched":
                lvol = stretched(lvol)
            light = sweep_fwd.sweep_light_stack(lvol.permute(plan.perm), plan,
                                                cfg).contiguous()
        if case.get("low"):
            stack = stack.to(torch.bfloat16)
            light = light.to(torch.bfloat16) if light is not None else None
        wrap = mode == "wrap"
        spans = build.tile_spans(*args[:3], args[4], stack.shape[1],
                                 stack.shape[2], wrap)
        need = build.stage_texels(spans)
        kw = dict(emission=em, flip=flip, address_mode=mode, light=light)
        want_maps = torch.stack(sweep_fwd.sweep_fwd_reference(stack, *args,
                                                              **kw))
        rng = np.random.default_rng(9)
        cts = [torch.tensor(rng.normal(size=plan.base_shape),
                            dtype=torch.float32, device=dev)
               for _ in range(3)]
        tol = BWD_TOL_GATE if medium.density > 100.0 else BWD_TOL
        first, parts = None, []
        for stage in (None, 0, need // 2):
            for mod in (sweep_fwd, sweep_bwd):
                mod.tiles.reset()
            maps = sweep_fwd.launch_kernel(stack, *args, em, flip, wrap,
                                           light, stage=stage)
            got = sweep_bwd.launch_kernel(stack, *args, *cts, maps[1],
                                          maps[2], em, flip, wrap,
                                          light=light, stage=stage)
            torch.cuda.synchronize()
            done, glob = sweep_fwd.tiles.read()
            bdone, bglob = sweep_bwd.tiles.read()
            if first is None:
                first = maps
                errs["sweep_fwd"].append(check_close(maps, want_maps,
                                                     f"tiled {what} maps"))
            elif not torch.equal(maps, first):
                fail(f"tiled {what}: K1 with stage {stage} differs from K1 "
                     "with the plan's stage")
            want = sweep_bwd.sweep_bwd_reference(stack, *args, *cts, maps[1],
                                                 maps[2], **kw)
            if light is None:
                got, want = (got,), (want,)
            e = max(check_grad(g, w, f"tiled {what} stage {stage}", tol)[0]
                    for g, w in zip(got, want))
            errs["sweep_bwd"].append(e)
            if stage == 0 and (glob, bglob) != (done, bdone):
                fail(f"tiled {what}: stage 0 computed {done - glob} tile-"
                     "slices from shared memory")
            parts.append(f"stage {need if stage is None else stage}: K1 "
                         f"{done} tile-slices ({glob} global), K2 {bdone} "
                         f"({bglob}), grads {e:.3e}")
        log(f"tiled {what}: base {plan.base_shape}, maps max abs err "
            f"{errs['sweep_fwd'][-1]:.3e}; " + "; ".join(parts))
    return errs


# --- the tiled schedule of K4 and K5 (kernels/csrc/sweep_ref_tile.cuh) -----
#
# As TILED_STRESS for K1 and K2: each case runs K4 and K5 with the stage the
# host sizes from the plan and the channel scales (build.ref_stage_for), with
# none and with half the largest window; K4's maps are equal bit for bit
# across the three and, like K5's gradients, held to the plain versions.
# Every case has a seeded (4, 3) scroll, whose windows cross mirror folds.
REF_TILED_STRESS = (
    ("seeded scroll across folds", dict(eye=SMALL_EYES[3][0], seed=7)),
    ("ragged base 100x70", dict(eye=SMALL_EYES[1][0], force=(100, 70))),
    ("ragged base 70x100, absorption",
     dict(eye=SMALL_EYES[2][0], emission=False, force=(70, 100))),
    ("channel scale above 1 (a window wider than the mirror's period)",
     dict(eye=SMALL_EYES[3][0], force=(20, 20),
          scales=(2.5, 0.8, 3.1, 0.7))),
    ("negative channel scale",
     dict(eye=SMALL_EYES[2][0], scales=(1.0, -0.8, 0.75, 0.7))),
    ("density 500", dict(eye=SMALL_EYES[0][0], density=500.0)),
    ("light with lT exactly 1", dict(eye=SMALL_EYES[3][0], light="ones",
                                     density=8.0)),
    ("light stretched", dict(eye=SMALL_EYES[4][0], light="stretched",
                             density=8.0)),
    ("bfloat16 with light", dict(eye=SMALL_EYES[0][0], light="ones",
                                 density=8.0, low=True)),
    ("windows beyond the stage, 128^3 x 4 on 56x56, absorption",
     dict(eye=SMALL_EYES[3][0], size=128, force=(56, 56), emission=False)),
)


def ref_tiled_stress_checks(dev):
    """The stress cases of K4's and K5's tiled schedule (REF_TILED_STRESS).
    Returns {kernel: [errors]}."""
    from volumetricrenderer_tpu_torch.kernels import build
    from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep
    errs = {"sweep_ref_fwd": [], "sweep_ref_bwd": []}
    lcfg = LightConfig(ambient=0.2, shadow_steps=32)
    for what, case in REF_TILED_STRESS:
        em, n = case.get("emission", True), case.get("size", 16)
        grid = torch.tensor(np.random.default_rng(0).uniform(0.1, 1.0,
                                                             (n,) * 3 + (4,)),
                            dtype=torch.float32, device=dev)
        cfg = RenderConfig(emission=em, quadrature="sliced")
        plan = plan_sweep(make_camera(CameraConfig(eye=case["eye"], width=96,
                                                   height=64)),
                          grid.shape, cfg, supersample=cfg.sweep_supersample,
                          force_base_dims=case.get("force"), device=dev)
        medium = MediumConfig(density=case.get("density", 1.0), **(
            {"channel_coord_scale": case["scales"]} if "scales" in case
            else {}))
        scroll = seeded_scroll(case.get("seed", REF_SCROLL_SEEDS[0]), dev)
        kind = case.get("light")
        L, *args = sweep_ref_fwd.sweep_ref_inputs(
            grid.permute(plan.perm + (3,)), plan, cfg, medium,
            lcfg if kind else None, scroll)
        L, light = L.contiguous(), None
        if kind:
            lvol = light_transmittance_volume(grid, lcfg, cfg, medium,
                                              scroll=scroll)
            if kind == "stretched":
                lvol = stretched(lvol)
            light = sweep_ref_fwd.sweep_ref_light_slabs(
                lvol.permute(plan.perm), plan, cfg).contiguous()
        if case.get("low"):
            L = L.to(torch.bfloat16)
            light = light.to(torch.bfloat16) if light is not None else None
        A, B, lit = L.shape[2], L.shape[3], light is not None
        spans = build.ref_tile_spans(*args[:3], args[4], A, B)
        lspans = (build.tile_spans(*args[:3], args[4], A, B, False)
                  if lit else None)
        need = build.ref_stage_texels(spans, lspans)
        bound = build.ref_stage_for(*args[:3], args[4], A, B, light=lit)
        if need > bound:
            fail(f"ref tiled {what}: a window of {need} slots exceeds the "
                 f"offset-free stage bound {bound}")
        want_maps = torch.stack(sweep_ref_fwd.sweep_ref_fwd_reference(
            L, *args, emission=em, light=light))
        rng = np.random.default_rng(9)
        cts = [torch.tensor(rng.normal(size=plan.base_shape),
                            dtype=torch.float32, device=dev)
               for _ in range(3)]
        tol = BWD_TOL_GATE if medium.density > 100.0 else BWD_TOL
        first, parts = None, []
        for stage in (None, 0, need // 2):
            for mod in (sweep_ref_fwd, sweep_ref_bwd):
                mod.tiles.reset()
            maps = sweep_ref_fwd.launch_kernel(L, *args, em, light,
                                               stage=stage)
            got = sweep_ref_bwd.launch_kernel(L, *args, *cts, maps[1],
                                              maps[2], emission=em,
                                              light=light, stage=stage)
            torch.cuda.synchronize()
            done, glob = sweep_ref_fwd.tiles.read()
            bdone, bglob = sweep_ref_bwd.tiles.read()
            if first is None:
                first = maps
                errs["sweep_ref_fwd"].append(check_close(
                    maps, want_maps, f"ref tiled {what} maps"))
            elif not torch.equal(maps, first):
                fail(f"ref tiled {what}: K4 with stage {stage} differs from "
                     "K4 with the plan's stage")
            want = sweep_ref_bwd.sweep_ref_bwd_reference(
                L, *args, *cts, maps[1], maps[2], emission=em, light=light)
            if light is None:
                got, want = (got,), (want,)
            e = max(check_grad(g, w, f"ref tiled {what} stage {stage}",
                               tol)[0] for g, w in zip(got, want))
            errs["sweep_ref_bwd"].append(e)
            size = bound if stage is None else stage
            mirror = (build.ref_tile_slices(
                spans, build.ref_stage_cap(size, False, lit), lspans),
                build.ref_tile_slices(
                    spans, build.ref_stage_cap(size, True, lit), lspans))
            if not em and ((done, glob), (bdone, bglob)) != mirror:
                fail(f"ref tiled {what} stage {stage}: tallies "
                     f"{(done, glob)}, {(bdone, bglob)} against the host "
                     f"mirror {mirror}")
            if stage == 0 and (glob, bglob) != (done, bdone):
                fail(f"ref tiled {what}: stage 0 computed "
                     f"{done - glob} tile-slices from shared memory")
            parts.append(f"stage {size}: K4 {done} tile-slices ({glob} "
                         f"global), K5 {bdone} ({bglob}), grads {e:.3e}")
        log(f"ref tiled {what}: base {plan.base_shape}, largest window "
            f"{need} slots, bound {bound}; maps max abs err "
            f"{errs['sweep_ref_fwd'][-1]:.3e}; " + "; ".join(parts))
    return errs


# --- the bfloat16 stream mode --------------------------------------------
#
# RenderConfig(dtype="bfloat16"): texels and tap weights rounded to bfloat16,
# everything else float32 (kernels/sweep_fwd.py). Kernel and plain version
# read the same bfloat16 stacks and round the weights alike, so they are held
# to the float32 phases' tolerances, and beyond them to BF16_MAP_LIMIT and
# BF16_GRAD_LIMIT (of max|gradient|; the early-stop cases keep BWD_TOL_GATE).
# A bfloat16 frame is held to the float32 frame as tests/test_bf16.py holds
# the JAX package's: max below 3e-2, mean below 3e-3.
BF16 = torch.bfloat16
BF16_MAP_LIMIT, BF16_GRAD_LIMIT = 1e-6, 1e-5
BF16_IMG_MAX, BF16_IMG_MEAN = 3e-2, 3e-3
# The oracle of the gradient check has no stream mode: it runs in float32 on
# the bfloat16-rounded grid, with unrounded tap weights. A weight rounds by
# up to 2^-9 = 2e-3 of itself, so the two gradients agree to that share of
# the scale and no closer. That the adjoint scatters with the rounded
# weights is held elsewhere: every small case holds the plain backward to
# autograd of the plain forward in the mode, and the kernel to the plain
# backward, within 1e-5.
BF16_ORACLE_TOL = 3e-3


def low_cfg(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def bf16_both(grid, lvol, plan, cfg, medium, light, scroll, cts,
              autograd=True):
    """The kernels' bfloat16 instantiations and the plain versions in the
    same mode on the same bfloat16 stacks, for either medium, with or
    without a light volume: the forward maps, and the gradients on the
    forward kernel's trans and wsum maps and the cotangents `cts`. With
    `autograd`, also the plain backward against autograd of the plain
    forward (_low=True on float32 copies of the bfloat16 stacks: autograd
    through a bfloat16 tensor would round the gradient). Comparison
    launches, not the main path. Returns (maps, plain maps, grads, plain
    grads, own, auto), the gradients as tuples (dG,) or (dG, dL)."""
    em = cfg.emission
    if medium.combine == "reference":
        stack, *args = sweep_ref_fwd.sweep_ref_inputs(
            grid.permute(plan.perm + (3,)), plan, cfg, medium, light, scroll)
        lstack = None if lvol is None else \
            sweep_ref_fwd.sweep_ref_light_slabs(lvol.permute(plan.perm),
                                                plan, cfg)
        kw = dict(emission=em)
        fwd, bwd = sweep_ref_fwd.sweep_ref_fwd_reference, \
            sweep_ref_bwd.sweep_ref_bwd_reference
    else:
        (stack, *args), flip = sweep_fwd.sweep_inputs(
            grid.permute(plan.perm), plan, cfg, medium, light)
        lstack = None if lvol is None else sweep_fwd.sweep_light_stack(
            lvol.permute(plan.perm), plan, cfg)
        kw = dict(emission=em, flip=flip, address_mode=cfg.address_mode)
        fwd, bwd = sweep_fwd.sweep_fwd_reference, \
            sweep_bwd.sweep_bwd_reference
    stack = stack.contiguous().to(BF16)
    lstack = None if lstack is None else lstack.contiguous().to(BF16)
    if medium.combine == "reference":
        maps = sweep_ref_fwd.launch_kernel(stack, *args, em, lstack)
        got = sweep_ref_bwd.launch_kernel(stack, *args, *cts, maps[1],
                                          maps[2], emission=em, light=lstack)
    else:
        wrap = cfg.address_mode == "wrap"
        maps = sweep_fwd.launch_kernel(stack, *args, em, flip, wrap, lstack)
        got = sweep_bwd.launch_kernel(stack, *args, *cts, maps[1], maps[2],
                                      em, flip, wrap, light=lstack)
    torch.cuda.synchronize()
    want_maps = fwd(stack, *args, light=lstack, **kw)
    want = bwd(stack, *args, *cts, maps[1], maps[2], light=lstack, **kw)
    if lstack is None:
        got, want = (got,), (want,)
    own = auto = None
    if autograd:
        st = stack.to(torch.float32).requires_grad_()
        lt = None if lstack is None else \
            lstack.to(torch.float32).requires_grad_()
        fmaps = fwd(st, *args, light=lt, _low=True, **kw)
        loss = sum((m * c).sum() for m, c in zip(fmaps[:3], cts))
        auto = torch.autograd.grad(loss, (st,) if lt is None else (st, lt))
        own = bwd(stack, *args, *cts, fmaps[1].detach(), fmaps[2].detach(),
                  light=lstack, **kw)
        own = (own,) if lstack is None else own
    return maps.unbind(0), want_maps, got, want, own, auto


def check_bf16_case(what, result, gate=False):
    """Holds one bf16_both result to the float32 phases' tolerances and to
    the bfloat16 limits; returns the maps' and the gradients' max abs
    errors."""
    maps, want_maps, got, want, own, auto = result
    tol = BWD_TOL_GATE if gate else BWD_TOL
    e = max(check_close(g, w, f"{what} {name}")
            for g, w, name in zip(maps, want_maps,
                                  ("acc", "trans", "wsum", "hit")))
    if not e <= BF16_MAP_LIMIT:
        fail(f"{what}: maps max abs err {e:.3e} above {BF16_MAP_LIMIT}")
    msg, e_bwd = f"{what}: maps max abs err {e:.3e}", 0.0
    for k, name in enumerate(("dG", "dL")[:len(got)]):
        e_k, s_k = check_grad(got[k], want[k], f"{what} {name}", tol)
        if not gate and not e_k <= BF16_GRAD_LIMIT * s_k:
            fail(f"{what} {name}: max abs err {e_k:.3e} above "
                 f"{BF16_GRAD_LIMIT} of max {s_k:.3e}")
        e_bwd = max(e_bwd, e_k)
        msg += f", {name} {e_k:.3e} (max {s_k:.3e})"
        if own is not None:
            a_k, _ = check_grad(own[k], auto[k],
                                f"{what} {name} (plain vs autograd)", tol)
            msg += f" plain vs autograd {a_k:.3e}"
    log(msg)
    return e, e_bwd


def check_weight_rounding(dev):
    """torch's float32 -> bfloat16 rounding against the device's
    __float2bfloat16_rn (the kernels' round_weight) on seeded weights,
    their complements and exact ties: both round to nearest even."""
    from volumetricrenderer_tpu_torch.kernels.build import bf16_round
    w = np.random.default_rng(0).uniform(0.0, 1.0, 8192).astype(np.float32)
    ties = ((w[:2048].view(np.uint32) & np.uint32(0xFFFF0000))
            | np.uint32(0x8000)).view(np.float32)
    x = torch.tensor(np.concatenate([w, 1.0 - w, ties, [0.0, 1.0]]),
                     dtype=torch.float32, device=dev)
    got = round_weights_on_device(x)
    torch.cuda.synchronize()
    bad = int((got != bf16_round(x)).sum())
    log(f"bf16 weight rounding: {bad} mismatches between torch's "
        f".to(bfloat16) and __float2bfloat16_rn on {x.numel()} values "
        f"({ties.size} exact ties)")
    if bad:
        fail("torch and the device round a weight to bfloat16 differently")


def bf16_small_checks(dev):
    """Step 17: the bfloat16 instantiations of the four kernels at small
    shapes, and the gradient check in the mode. Returns {kernel: [errors]}."""
    errs = {name: [] for name in KERNELS}
    check_weight_rounding(dev)
    light = LightConfig(ambient=0.2, shadow_steps=32)
    rng = np.random.default_rng(0)
    small = torch.tensor(rng.uniform(0.2, 1.0, (16, 16, 16)),
                         dtype=torch.float32, device=dev)
    small4 = torch.tensor(rng.uniform(0.1, 1.0, (16, 16, 16, 4)),
                          dtype=torch.float32, device=dev)
    scroll = seeded_scroll(REF_SCROLL_SEEDS[0], dev)
    eye0 = SMALL_EYES[0]
    # (combine, (eye, axis, sign), emission, address mode, light kind,
    #  n_slices, density)
    cases = [("single", eye, em, mode, None, None, 8.0)
             for eye in SMALL_EYES for em in (True, False)
             for mode in ("mirror", "clamp", "wrap")]
    cases += [("single", eye, True, mode, kind, None, 8.0)
              for eye in SMALL_EYES for mode in ("mirror", "wrap")
              for kind in ("ones", "stretched")]
    cases += [("single", eye0, em, "mirror", kind, 24, 8.0)
              for em, kind in ((True, None), (False, None), (True, "ones"),
                               (True, "stretched"))]
    cases += [("single", eye0, True, "mirror", kind, None, 500.0)
              for kind in (None, "ones")]
    cases += [("reference", eye, em, "mirror", None, None, 1.0)
              for eye in SMALL_EYES for em in (True, False)]
    cases += [("reference", eye, True, "mirror", kind, None, 8.0)
              for eye in SMALL_EYES for kind in ("ones", "stretched")]
    cases += [("reference", eye0, em, "mirror", kind, 24, 8.0)
              for em, kind in ((True, None), (False, None),
                               (True, "stretched"))]
    cases += [("reference", eye0, True, "mirror", kind, None, 500.0)
              for kind in (None, "ones")]
    brng = np.random.default_rng(9)
    for combine, (eye, axis, sign), em, mode, kind, n_slices, density \
            in cases:
        ref = combine == "reference"
        grid, sc = (small4, scroll) if ref else (small, None)
        cfg = RenderConfig(emission=em, quadrature="sliced",
                           address_mode=mode)
        medium = MediumConfig(combine=combine, density=density)
        cam = make_camera(CameraConfig(eye=eye, width=96, height=64))
        plan = plan_for(cam, grid.shape, cfg, n_slices=n_slices, device=dev)
        if (plan.axis, plan.sign) != (axis, sign):
            fail(f"eye {eye}: plan sweeps axis {plan.axis} sign {plan.sign},"
                 f" expected {axis} {sign}")
        lvol = None
        if kind:
            lvol = light_transmittance_volume(grid, light, cfg, medium,
                                              scroll=sc)
            if kind == "stretched":
                lvol = stretched(lvol)
        cts = [torch.tensor(brng.normal(size=plan.base_shape),
                            dtype=torch.float32, device=dev)
               for _ in range(3)]
        what = (f"bf16 small {combine} eye={eye} axis={axis} "
                f"sign={sign:+d} emission={em} {mode} light={kind} "
                f"n_slices={n_slices} density={density}")
        result = bf16_both(grid, lvol, plan, cfg, medium,
                           light if kind else None, sc, cts)
        gate = density > 100.0
        if gate and not float(result[0][1].min()) < 1e-3:
            fail(f"{what}: no ray reached the early-stop gate")
        e, e_bwd = check_bf16_case(what, result, gate)
        errs["sweep_ref_fwd" if ref else "sweep_fwd"].append(e)
        errs["sweep_ref_bwd" if ref else "sweep_bwd"].append(e_bwd)
    log(f"bf16 small cases: {len(cases)} passed")

    # bench.py's gradient check in the mode: the kernels' grid gradient on
    # an identity-warp plan (bfloat16 texels and weights) against the
    # per-ray oracle in float32 on the bfloat16-rounded grid.
    from volumetricrenderer_tpu_torch.kernels.build import bf16_round
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    cam = make_camera(CameraConfig(width=48, height=32))
    g24 = bf16_round(cloud_volume(24, 7, device=dev))
    plan = plan_for(cam, g24.shape, cfg, device=dev)
    ident = dataclasses.replace(plan, identity_warp=True)
    o, d = base_rays(plan)
    g2 = g24.clone().requires_grad_()
    (render_rays_sliced(g2, o, d, plan, cfg, medium)[..., :3] ** 2).sum() \
        .backward()
    scale = float(g2.grad.abs().max())
    found = {}
    for name, c in (("float32", cfg), ("bfloat16", low_cfg(cfg))):
        g1 = g24.clone().requires_grad_()
        (sweep_render(g1, ident, c, medium)[..., :3] ** 2).sum().backward()
        if g1.grad.dtype != torch.float32:
            fail(f"grad check {name}: the grid gradient is {g1.grad.dtype}")
        found[name] = max_err(g1.grad, g2.grad)
    tol = BF16_ORACLE_TOL
    ok = scale > 0.0 and found["float32"] <= 1e-3 * scale \
        and found["bfloat16"] <= tol * scale
    log(f"bf16 grad check against the float32 oracle on the rounded grid: "
        f"ok={ok} max_abs_err={found['bfloat16']:.3e} (tolerance {tol} of "
        f"the scale) beside float32's {found['float32']:.3e}, "
        f"scale={scale:.3e}")
    if not ok:
        fail("bf16 gradient check: the kernels' grid gradient disagrees "
             "with the per-ray oracle's")
    return errs


def check_low_image(name, img, f32):
    """A bfloat16 frame against the float32 frame of the same view."""
    if img.dtype != torch.float32 or img.shape != f32.shape \
            or not bool(torch.isfinite(img).all()):
        fail(f"{name}: dtype {img.dtype}, shape {tuple(img.shape)} or "
             "non-finite pixels")
    d = (img - f32).abs()
    d_max, d_mean = float(d.max()), float(d.mean())
    if not (0.0 < d_max < BF16_IMG_MAX and d_mean < BF16_IMG_MEAN):
        fail(f"{name}: bf16 frame differs from float32 by max {d_max:.3e} "
             f"(limit {BF16_IMG_MAX}, and above 0), mean {d_mean:.3e} "
             f"(limit {BF16_IMG_MEAN})")
    return d_max, d_mean


def low_plain_maps(grid, lvol, plan, cfg, medium, light, scroll):
    """(kernel maps, plain maps) in the mode at full width: comparison
    launches, not the main path."""
    maps, want_maps, *_ = bf16_both(
        grid, lvol, plan, cfg, medium, light, scroll,
        [torch.zeros(plan.base_shape, device=grid.device)] * 3,
        autograd=False)
    return maps, want_maps


def check_low_frame(name, img, f32, grid, lvol, plan, cfg, medium, light,
                    scroll, held=True):
    """One bfloat16 frame of a main path: against the float32 frame, and
    (when held) its base maps and image against the plain version in the
    mode. Returns the errors."""
    d_max, d_mean = check_low_image(name, img, f32)
    msg = (f"{name}: against float32 max {d_max:.3e}, mean {d_mean:.3e}")
    out = []
    if held:
        maps, want_maps = low_plain_maps(grid, lvol, plan, cfg, medium,
                                         light, scroll)
        e = max(check_close(g, w, f"{name} {n}")
                for g, w, n in zip(maps, want_maps,
                                   ("acc", "trans", "wsum", "hit")))
        e_img = check_close(img, finish_image(want_maps, plan, cfg, medium,
                                              light), f"{name} image")
        if not max(e, e_img) <= BF16_MAP_LIMIT:
            fail(f"{name}: maps {e:.3e} or image {e_img:.3e} above "
                 f"{BF16_MAP_LIMIT}")
        msg += f"; maps max abs err {e:.3e}, image {e_img:.3e}"
        out = [e, e_img]
    log(msg)
    return out


def low_step(name, grid, cam, plan, cfg, medium, light, scroll, bwd_mod,
             expect):
    """One forward+backward step in the mode (sum of rgb^2, gradient to the
    float32 grid), counted, its gradients held to the plain backward on
    the same bfloat16 stacks and cotangents. Returns (errors, launches)."""
    reset_counts()
    g = grid.clone().requires_grad_()
    with BackwardSpy(bwd_mod) as spy:
        img = render_image(g, cam, low_cfg(cfg), medium, light,
                           scroll=scroll, plan=plan)
        loss = (img[..., :3] ** 2).sum()
        loss.backward()
        torch.cuda.synchronize()
    launches = path_counts(name)
    if launches != expect or len(spy.seen) != 1:
        fail(f"{name} launched {launches}, expected {expect}")
    if g.grad.dtype != torch.float32 \
            or not bool(torch.isfinite(g.grad).all()) \
            or not float(g.grad.abs().max()) > 0.0:
        fail(f"{name}: the grid gradient is {g.grad.dtype}, or not finite "
             "and nonzero")
    a, kw, got = spy.seen[0]
    if a[0].dtype != BF16:
        fail(f"{name}: the backward kernel read a {a[0].dtype} stack")
    if bwd_mod is sweep_bwd:
        want = sweep_bwd.sweep_bwd_reference(
            *a[:11], emission=a[11], flip=a[12],
            address_mode=cfg.address_mode, **kw)
    else:
        want = sweep_ref_bwd.sweep_ref_bwd_reference(*a, **kw)
    if kw.get("light") is None:
        got, want = (got,), (want,)
    errs, msg = [], ""
    for k, (gk, wk) in enumerate(zip(got, want)):
        if gk.dtype != torch.float32:
            fail(f"{name}: a kernel gradient is {gk.dtype}")
        e, s = check_grad(gk, wk, f"{name} gradient {k}")
        if not e <= BF16_GRAD_LIMIT * s:
            fail(f"{name} gradient {k}: {e:.3e} above {BF16_GRAD_LIMIT} of "
                 f"max {s:.3e}")
        errs.append(e)
        msg += f" {('dG', 'dL')[k]} max abs err {e:.3e} at max {s:.3e},"
    log(f"{name}: loss {loss.item():.6e}, launches {launches},{msg} grid "
        f"gradient max {float(g.grad.abs().max()):.3e}")
    return errs, launches


def bf16_full_width(dev, grid, flag_frames, flag_cams, grid4, cam4, plan4):
    """Step 18: the main paths in the bfloat16 stream mode at full width,
    each counted from 0. Returns ({kernel: [errors]}, [launch tuples])."""
    errs = {name: [] for name in KERNELS}
    paths = []
    cfg = RenderConfig(emission=True, quadrature="sliced")
    low = low_cfg(cfg)
    medium = MediumConfig(combine="single", density=8.0)

    # The flagship serving frames and the forward+backward step.
    reset_counts()
    imgs = []
    for (name, plan, _), (_, cam) in zip(flag_frames, flag_cams):
        imgs.append(render_image(grid, cam, low, medium, plan=plan))
        torch.cuda.synchronize()
    paths.append(path_counts("bf16 flagship serving"))
    if paths[-1] != (len(imgs), 0, 0, 0):
        fail(f"bf16 serving path launched {paths[-1]}, expected "
             f"({len(imgs)}, 0, 0, 0)")
    for (name, plan, f32), img in zip(flag_frames, imgs):
        errs["sweep_fwd"] += check_low_frame(
            f"bf16 flagship {name}", img, f32, grid, None, plan, cfg, medium,
            None, None)
    e, launches = low_step("bf16 flagship fwd+bwd", grid, flag_cams[0][1],
                           flag_frames[0][1], cfg, medium, None, None,
                           sweep_bwd, (1, 1, 0, 0))
    errs["sweep_bwd"] += e
    paths.append(launches)

    # The reference preset: eight frames and one step per mode.
    rmed = MediumConfig()
    scrolls = [reference_media_scroll(t, device=dev) for t in REF_TIMES]
    scrolls += [seeded_scroll(seed, dev) for seed in REF_SCROLL_SEEDS]
    cfgs = [RenderConfig(emission=em, quadrature="sliced")
            for em in (False, True)]
    reset_counts()
    frames = []
    for c in cfgs:
        for sc in scrolls:
            frames.append((c, sc, render_image(grid4, cam4, low_cfg(c), rmed,
                                               scroll=sc, plan=plan4)))
            torch.cuda.synchronize()
    paths.append(path_counts("bf16 reference"))
    if paths[-1] != (0, 0, len(frames), 0):
        fail(f"bf16 reference serving path launched {paths[-1]}, expected "
             f"(0, 0, {len(frames)}, 0)")
    for k, (c, sc, img) in enumerate(frames):
        f32 = render_image(grid4, cam4, c, rmed, scroll=sc, plan=plan4)
        errs["sweep_ref_fwd"] += check_low_frame(
            f"bf16 reference emission={c.emission} scroll {k % 4}", img, f32,
            grid4, None, plan4, c, rmed, None, sc)
    for c in cfgs:
        e, launches = low_step(
            f"bf16 reference fwd+bwd emission={c.emission}", grid4, cam4,
            plan4, c, rmed, None, scrolls[2], sweep_ref_bwd, (0, 0, 1, 1))
        errs["sweep_ref_bwd"] += e
        paths.append(launches)

    # Config 4: four shadowed orbit frames (the light volume is built in
    # float32 and cast inside the node) and one shadowed step.
    light = CONFIG4_LIGHT
    cams = [orbit_camera(2.0 * math.pi * i / 4, width=WIDTH, height=HEIGHT)
            for i in range(4)]
    plans = [plan_for(cam, grid.shape, cfg, device=dev) for cam in cams]
    reset_counts()
    imgs = []
    for cam, plan in zip(cams, plans):
        imgs.append(render_image(grid, cam, low, medium, light, plan=plan))
        torch.cuda.synchronize()
    paths.append(path_counts("bf16 config 4"))
    if paths[-1] != (len(imgs), 0, 0, 0):
        fail(f"bf16 config 4 serving path launched {paths[-1]}, expected "
             f"({len(imgs)}, 0, 0, 0)")
    lvol = light_transmittance_volume(grid, light, cfg, medium)
    held = {}
    for i, plan in enumerate(plans):
        held.setdefault(plan.sign, i)
    for i, (cam, plan, img) in enumerate(zip(cams, plans, imgs)):
        f32 = render_image(grid, cam, cfg, medium, light, plan=plan,
                           light_volume=lvol)
        errs["sweep_fwd"] += check_low_frame(
            f"bf16 config 4 frame {i} (axis {plan.axis}, sign "
            f"{plan.sign:+d})", img, f32, grid, lvol, plan, cfg, medium,
            light, None, held=i in held.values())
    e, launches = low_step("bf16 config 4 fwd+bwd", grid, cams[0], plans[0],
                           cfg, medium, light, None, sweep_bwd, (1, 1, 0, 0))
    errs["sweep_bwd"] += e
    paths.append(launches)

    # The reference medium with shadows, density 8: two frames, one step.
    smed = REF_SHADOW_MEDIUM
    reset_counts()
    frames = []
    for sc in scrolls[2:]:
        frames.append((sc, render_image(grid4, cam4, low, smed, light,
                                        scroll=sc, plan=plan4)))
        torch.cuda.synchronize()
    paths.append(path_counts("bf16 reference shadowed"))
    if paths[-1] != (0, 0, len(frames), 0):
        fail(f"bf16 reference shadowed serving launched {paths[-1]}, "
             f"expected (0, 0, {len(frames)}, 0)")
    for k, (sc, img) in enumerate(frames):
        lv4 = light_transmittance_volume(grid4, light, cfg, smed, scroll=sc)
        f32 = render_image(grid4, cam4, cfg, smed, light, scroll=sc,
                           plan=plan4, light_volume=lv4)
        errs["sweep_ref_fwd"] += check_low_frame(
            f"bf16 reference shadowed frame {k}", img, f32, grid4, lv4,
            plan4, cfg, smed, light, sc)
    e, launches = low_step("bf16 reference shadowed fwd+bwd", grid4, cam4,
                           plan4, cfg, smed, light, scrolls[2],
                           sweep_ref_bwd, (0, 0, 1, 1))
    errs["sweep_ref_bwd"] += e
    paths.append(launches)
    log(f"bf16 main paths: launches (fwd, bwd, ref_fwd, ref_bwd) per path "
        f"{paths}")
    return errs, paths


def bf16_timings(grid, cam, plan, cam_c4, plan_c4, grid4, cam4, plan4, dev,
                 gpu_line):
    """Step 19: CUDA-event timings of the four kernels in bfloat16 beside
    float32 on the same plans, without and with a light volume, and of
    render_image and the forward+backward step in the mode with a float32
    grid (the cast included) and with a bfloat16 grid. Returns {kernel:
    {"ms", "plain_ms", "ms_light", "f32", "f32_light", work, work_light}},
    the work as (samples, lines, tensors) for the bounds."""
    cfg = RenderConfig(emission=True, quadrature="sliced")
    light = CONFIG4_LIGHT
    out = {name: {} for name in KERNELS}

    def single(plan, lvol, tag):
        medium = MediumConfig(combine="single", density=8.0)
        (stack, *args), flip = sweep_fwd.sweep_inputs(
            grid.permute(plan.perm), plan, cfg, medium,
            light if lvol is not None else None)
        stack = stack.contiguous()
        lstack = None if lvol is None else sweep_fwd.sweep_light_stack(
            lvol.permute(plan.perm), plan, cfg).contiguous()
        cts = [torch.randn(plan.base_shape, device=dev) for _ in range(3)]
        samples, lines = inbox_samples(plan)
        t = {}
        for name, st, ls in (("f32", stack, lstack),
                             ("bf16", stack.to(BF16),
                              None if lstack is None else lstack.to(BF16))):
            maps = sweep_fwd.launch_kernel(st, *args, True, flip, False, ls)
            t[name] = (
                cuda_ms(lambda: sweep_fwd.launch_kernel(
                    st, *args, True, flip, False, ls)),
                cuda_ms(lambda: sweep_bwd.launch_kernel(
                    st, *args, *cts, maps[1], maps[2], True, flip, False,
                    light=ls)))
            if name == "bf16":
                work = ((samples, lines, (st, *args, ls, maps)),
                        (samples, lines, (st, *args, ls, *cts[1:], maps[1],
                                          maps[2], stack, lstack)))
                if lvol is None:
                    kw = dict(emission=True, flip=flip,
                              address_mode=cfg.address_mode)
                    t["plain"] = (
                        cuda_ms(lambda: sweep_fwd.sweep_fwd_reference(
                            st, *args, **kw), runs=3, warmup=1),
                        cuda_ms(lambda: sweep_bwd.sweep_bwd_reference(
                            st, *args, *cts, maps[1], maps[2], **kw),
                            runs=3, warmup=1))
        for k, kname in enumerate(("sweep_fwd", "sweep_bwd")):
            log(f"  {kname}{tag}: bfloat16 {t['bf16'][k]:.3f} ms, float32 "
                f"{t['f32'][k]:.3f} ms"
                + (f", plain version in bfloat16 {t['plain'][k]:.3f} ms"
                   if "plain" in t else ""))
        return t, work

    def reference(medium, lit, tag):
        scroll = seeded_scroll(REF_SCROLL_SEEDS[0], dev)
        L, *args = sweep_ref_fwd.sweep_ref_inputs(
            grid4.permute(plan4.perm + (3,)), plan4, cfg, medium,
            light if lit else None, scroll)
        slabs = None
        if lit:
            lv4 = light_transmittance_volume(grid4, light, cfg, medium,
                                             scroll=scroll)
            slabs = sweep_ref_fwd.sweep_ref_light_slabs(
                lv4.permute(plan4.perm), plan4, cfg)
        cts = [torch.randn(plan4.base_shape, device=dev) for _ in range(3)]
        samples, lines = inbox_samples(plan4)
        t = {}
        for name, st, ls in (("f32", L, slabs),
                             ("bf16", L.to(BF16),
                              None if slabs is None else slabs.to(BF16))):
            maps = sweep_ref_fwd.launch_kernel(st, *args, True, ls)
            t[name] = (
                cuda_ms(lambda: sweep_ref_fwd.launch_kernel(st, *args, True,
                                                            ls)),
                cuda_ms(lambda: sweep_ref_bwd.launch_kernel(
                    st, *args, *cts, maps[1], maps[2], emission=True,
                    light=ls)))
            if name == "bf16":
                work = ((samples, lines, (st, *args, ls, maps)),
                        (samples, lines, (st, *args, ls, *cts[1:], maps[1],
                                          maps[2], L, slabs)))
                if not lit:
                    t["plain"] = (
                        cuda_ms(lambda: sweep_ref_fwd.sweep_ref_fwd_reference(
                            st, *args, emission=True), runs=3, warmup=1),
                        cuda_ms(lambda: sweep_ref_bwd.sweep_ref_bwd_reference(
                            st, *args, *cts, maps[1], maps[2],
                            emission=True), runs=3, warmup=1))
        for k, kname in enumerate(("sweep_ref_fwd", "sweep_ref_bwd")):
            log(f"  {kname}{tag}: bfloat16 {t['bf16'][k]:.3f} ms, float32 "
                f"{t['f32'][k]:.3f} ms"
                + (f", plain version in bfloat16 {t['plain'][k]:.3f} ms"
                   if "plain" in t else ""))
        return t, work

    log(f"[{gpu_line}] the bfloat16 stream mode beside float32, same plans "
        "(flagship; config 4 orbit frame 0 with light; the reference preset, "
        "with light at density 8):")
    lvol = light_transmittance_volume(
        grid, light, cfg, MediumConfig(combine="single", density=8.0))
    t0, w0 = single(plan, None, "")
    t1, w1 = single(plan_c4, lvol, " with light")
    r0, rw0 = reference(MediumConfig(), False, "")
    r1, rw1 = reference(REF_SHADOW_MEDIUM, True, " with light")
    for names, t, w, tl, wl in ((("sweep_fwd", "sweep_bwd"), t0, w0, t1, w1),
                                (("sweep_ref_fwd", "sweep_ref_bwd"), r0, rw0,
                                 r1, rw1)):
        for k, name in enumerate(names):
            out[name] = dict(ms=t["bf16"][k], plain_ms=t["plain"][k],
                             f32=t["f32"][k], ms_light=tl["bf16"][k],
                             f32_light=tl["f32"][k], work=w[k],
                             work_light=wl[k])

    # Frames and steps: float32; bfloat16 from a float32 grid (the node
    # casts: a separate pass over the volume); bfloat16 from a bfloat16 grid
    # (a viewer with a static grid casts once). The frames of a view are
    # timed in turns, float32 first and last (these frames are bound by the
    # host's launches, whose time drifts within a run), then the steps.
    def frames_and_steps(view, variants, c, medium, lt, scroll, pl,
                         runs=TIMED_RUNS):
        rays = c.width * c.height

        def render_ms(g, rc):
            return cuda_ms(lambda: render_image(g, c, rc, medium, lt,
                                                scroll=scroll, plan=pl),
                           runs=runs)
        for name, g, rc in variants + variants[:1]:
            ms = render_ms(g, rc)
            log(f"  {view} {name}: render_image {ms:.3f} ms = "
                f"{rays / (ms * 1e-3):.4g} rays/s")
        for name, g, rc in variants:
            leaf = g.clone().requires_grad_()

            def fwdbwd():
                leaf.grad = None
                (render_image(leaf, c, rc, medium, lt, scroll=scroll,
                              plan=pl)[..., :3] ** 2).sum().backward()
            fb = cuda_ms(fwdbwd, runs=runs)
            log(f"  {view} {name}: forward+backward step {fb:.3f} ms = "
                f"{rays / (fb * 1e-3):.4g} rays/s")

    medium = MediumConfig(combine="single", density=8.0)
    low = low_cfg(cfg)
    cast_ms = cuda_ms(lambda: grid.to(BF16))
    log(f"  cast of the {tuple(grid.shape)} grid to bfloat16: {cast_ms:.3f} "
        "ms")

    def variants(g):
        return [("float32", g, cfg),
                ("bfloat16, float32 grid (cast included)", g, low),
                ("bfloat16, bfloat16 grid", g.to(BF16), low)]
    frames_and_steps("flagship", variants(grid), cam, medium, None, None,
                     plan)
    frames_and_steps("reference preset", variants(grid4), cam4,
                     MediumConfig(), None,
                     seeded_scroll(REF_SCROLL_SEEDS[0], dev), plan4)
    frames_and_steps("config 4 shadowed", variants(grid)[:2], cam_c4, medium,
                     light, None, plan_c4, runs=4)
    return out


PRESET_NAMES = ("config1", "config2", "config3", "config4", "reference")


def preset_held(name, img, grid, lvol, plan, cfg, medium, light):
    """A float32 preset frame `img` against the plain version at the
    preset's own shapes: the forward kernel's base maps on the (D, H, W)
    grid (and light volume) held to sweep_fwd_reference on the same stacks,
    and the frame held to finish_image of the plain maps. Comparison
    launches, not the main path. Returns (maps error, image error)."""
    (stack, *args), flip = sweep_fwd.sweep_inputs(
        grid.permute(plan.perm), plan, cfg, medium, light)
    stack = stack.contiguous()
    lstack = None if lvol is None else sweep_fwd.sweep_light_stack(
        lvol.permute(plan.perm), plan, cfg).contiguous()
    wrap = cfg.address_mode == "wrap"
    with torch.no_grad():
        got = sweep_fwd.launch_kernel(stack, *args, cfg.emission, flip, wrap,
                                      lstack).unbind(0)
        torch.cuda.synchronize()
        want = sweep_fwd.sweep_fwd_reference(
            stack, *args, emission=cfg.emission, flip=flip,
            address_mode=cfg.address_mode, light=lstack)
        e = max(check_close(g, w, f"{name} {n}")
                for g, w, n in zip(got, want, ("acc", "trans", "wsum", "hit")))
        e_img = check_close(img, finish_image(want, plan, cfg, medium, light),
                            f"{name} image")
    log(f"{name}: stack {tuple(stack.shape)}, base {plan.base_shape}, "
        f"light volume {lvol is not None}; kernel against plain version: "
        f"maps max abs err {e:.3e}, image {e_img:.3e}")
    return e, e_img


def preset_front_end(dev, out_dir):
    """Step 20: the preset front end on the card: `cli render --preset` for
    each preset at its own full size (launches counted from 0 around each
    command, wall time with the volume and plan build), the PNG against
    render_image on the same grid, config2 also in bfloat16 through
    render_preset, and `cli info`. Each sliced preset's frame is also held
    to the plain version at the shapes the preset gives the kernel (its own
    volume and image size; grid[..., 0] of the (D, H, W, 1) grid, or the
    baked grid): the base maps, and the frame against finish_image of the
    plain maps. Returns ([launch tuples] of the presets that reach a
    kernel, {kernel: [errors]})."""
    from volumetricrenderer_tpu_torch import (PRESETS, cli, render_preset,
                                              render_scene)
    from volumetricrenderer_tpu_torch.models import scene as scene_mod
    from volumetricrenderer_tpu_torch.utils.image import encode_png
    paths, errs = [], {name: [] for name in KERNELS}
    for name in PRESET_NAMES:
        p = PRESETS[name]
        out = os.path.join(out_dir, f"chip_smoke_preset_{name}.png")
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["render", "--preset", name, "--out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = path_counts(f"cli render --preset {name}")
        if rc != 0:
            fail(f"cli render --preset {name} returned {rc}")
        sliced = p.render.quadrature == "sliced"
        if launches != ((1, 0, 0, 0) if sliced else (0, 0, 0, 0)):
            fail(f"cli render --preset {name} launched {launches}")
        # The same frame through render_image on the same grid.
        cam = make_camera(p.camera)
        t0 = time.perf_counter()
        with torch.no_grad():
            if p.scene:
                vols = getattr(scene_mod, p.scene)(p.volume.size, device=dev)
                grid = bake_scene(vols, p.volume.size, p.render)
                scroll = None
            else:
                grid = build_volume(p.volume, device=dev)
                scroll = reference_media_scroll(
                    0.0, n_channels=grid.shape[-1], device=dev)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = render_image(grid, cam, p.render, p.medium, p.light,
                                scroll=scroll)
            torch.cuda.synchronize()
            render_s = time.perf_counter() - t0
            again = render_preset(p, grid=None if p.scene else grid,
                                  device=dev)
        if tuple(want.shape) != (p.camera.height, p.camera.width, 4) \
                or not bool(torch.isfinite(want).all()) \
                or not float(want[..., 3].max()) > 0.0:
            fail(f"preset {name}: shape {tuple(want.shape)}, non-finite or "
                 "empty frame")
        if not torch.equal(again, want):
            fail(f"preset {name}: render_preset and render_image on the "
                 f"same grid differ by {max_err(again, want):.3e}")
        with open(out, "rb") as f:
            if f.read() != encode_png(want):
                fail(f"preset {name}: the PNG of cli render is not "
                     "render_image's frame")
        log(f"cli render --preset {name}: volume {p.volume.size}^3, "
            f"{p.camera.width}x{p.camera.height}, wall {wall:.3f} s with the "
            f"volume, plan and kernel set-up (volume build alone "
            f"{build_s:.3f} s, render_image with its plan {render_s:.3f} s), "
            f"launches (fwd, bwd, ref_fwd, ref_bwd) {launches}"
            + ("" if sliced else ": quadrature \"fixed\" marches per ray and "
               "launches no kernel")
            + f"; PNG equals render_image on the same grid, alpha mean "
            f"{float(want[..., 3].mean()):.4f}")
        if sliced:
            paths.append(launches)
            # The kernel against its plain version at this preset's shapes
            # (comparison launches, after the counted command).
            g3 = grid[..., 0] if grid.dim() == 4 else grid
            plan = plan_for(cam, g3.shape, p.render, device=dev)
            shadowed = p.render.emission and p.light.shadow_steps > 0
            with torch.no_grad():
                lvol = light_transmittance_volume(
                    g3, p.light, p.render, p.medium) if shadowed else None
            e, e_img = preset_held(f"preset {name}", want, g3, lvol, plan,
                                   p.render, p.medium, p.light)
            errs["sweep_fwd"] += [e, e_img]
        if name == "config2":
            lowp = dataclasses.replace(p, render=low_cfg(p.render))
            reset_counts()
            with torch.no_grad():
                img = render_preset(lowp, grid=grid, device=dev)
            torch.cuda.synchronize()
            if counts() != (1, 0, 0, 0):
                fail(f"render_preset(config2, bfloat16) launched {counts()}")
            paths.append(path_counts("render_preset(config2, bfloat16)"))
            log(f"render_preset(config2, dtype=bfloat16): launches "
                f"{counts()}")
            errs["sweep_fwd"] += check_low_frame(
                "preset config2 bfloat16", img, want, g3, None, plan,
                p.render, p.medium, p.light, None)
        del grid, want, again
    if cli.main(["info"]) != 0:
        fail("cli info failed")
    return paths, errs


# --- the viewer front end: serve and animate (step 21) -------------------

# serve.py's self-drive through the real HTTP stack on loopback: preset and
# frames served after the warm-up.
SERVE_RUNS = (("config2", 32), ("config4", 16))
# The walk of lattice states that times what two frames in flight buy:
# states (azimuth steps, opposite the served ones, so first visits are
# plan-cache misses) and frames per timed loop.
WALK_STATES, WALK_FRAMES = 8, 24
ANIMATE_FRAMES = 8


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServeSpy:
    """For the time of a `with` block, serve.py's InteractiveRenderer and
    FrameLoop are subclasses that record the renderer serve() builds, the
    lattice state of each frame it dispatches in order (the state
    _plan_cached is given) with the host time of each plan-cache miss, and
    the last frame a FrameLoop handed to a viewer with its sequence number
    (frame seq is the seq-th dispatch) and the clock of every frame handed
    out; error records the package logs (a frame that failed) are kept
    too."""

    def __init__(self, module):
        self.module = module
        self.renderer, self.states, self.served = None, [], None
        self.misses, self.handed, self.errors = [], [], []

    def __enter__(self):
        import logging
        spy, mod = self, self.module
        self.classes = (mod.InteractiveRenderer, mod.FrameLoop)

        class Renderer(self.classes[0]):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                spy.renderer = self

            def _plan_cached(self, az, el, d):
                spy.states.append((az, el, d))
                before, t0 = self.plan_cache_misses, time.perf_counter()
                plan = super()._plan_cached(az, el, d)
                if self.plan_cache_misses != before:
                    spy.misses.append((t0, time.perf_counter() - t0))
                return plan

        class Loop(self.classes[1]):
            def next_frame(self, after_seq, timeout=600.0):
                seq, img = super().next_frame(after_seq, timeout)
                spy.served = (seq, img)
                spy.handed.append(time.perf_counter())
                return seq, img

        class Errors(logging.Handler):
            def emit(self, record):
                if record.levelno >= logging.ERROR:
                    spy.errors.append(record.getMessage())

        mod.InteractiveRenderer, mod.FrameLoop = Renderer, Loop
        self.handler = Errors()
        mod.get_logger().addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.module.InteractiveRenderer, self.module.FrameLoop = self.classes
        self.module.get_logger().removeHandler(self.handler)


def served_uint8(img):
    """serve.py's frame conversion: RGB over the page background, uint8."""
    from volumetricrenderer_tpu_torch.serve import _PAGE_BG
    a = img[..., 3:4]
    rgb = img[..., :3] * a + _PAGE_BG * (1.0 - a)
    return torch.clamp(rgb * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def plain_frame(grid, plan, cfg, medium, light):
    """The frame of the plain version at a preset's shapes: the light
    volume from the grid where the preset shades, sweep_fwd_reference on
    the kernel's inputs (channel 0 of a (D, H, W, 1) grid), finish_image."""
    g3 = grid[..., 0] if grid.dim() == 4 else grid
    with torch.no_grad():
        lvol = (light_transmittance_volume(g3, light, cfg, medium)
                if cfg.emission and light.shadow_steps > 0 else None)
        (stack, *args), flip = sweep_fwd.sweep_inputs(
            g3.permute(plan.perm), plan, cfg, medium, light)
        lstack = None if lvol is None else sweep_fwd.sweep_light_stack(
            lvol.permute(plan.perm), plan, cfg).contiguous()
        maps = sweep_fwd.sweep_fwd_reference(
            stack.contiguous(), *args, emission=cfg.emission, flip=flip,
            address_mode=cfg.address_mode, light=lstack)
        return finish_image(maps, plan, cfg, medium, light)


def count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): returns (result,
    ["file:line" of each synchronizing call])."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]


def plan_bytes(plan):
    """Device bytes of a sweep plan's tensors."""
    return sum(t.numel() * t.element_size()
               for t in (getattr(plan, f.name)
                         for f in dataclasses.fields(plan))
               if isinstance(t, torch.Tensor))


def serve_cell(name, n_frames, gpu_line):
    """serve(PRESETS[name], frames=n_frames) on the card through loopback
    HTTP, counted from 0: K1 must launch once per frame rendered and no
    frame may fail; the last served frame is held to render_image at its
    state and plan (bit for bit) and to the plain version's frame (within
    1 level). Returns (renderer, result, launches, errors)."""
    from volumetricrenderer_tpu_torch import PRESETS
    from volumetricrenderer_tpu_torch import serve as serve_mod
    preset = PRESETS[name]
    reset_counts()
    with ServeSpy(serve_mod) as spy:
        t0 = time.perf_counter()
        res = serve_mod.serve(preset, port=free_port(), frames=n_frames,
                              device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_counts(f"serve {name}")
    r = spy.renderer
    if spy.errors:
        fail(f"serve {name}: a frame failed: {spy.errors[0]}")
    if not res["mouse_drag_wheel_ok"]:
        fail(f"serve {name}: the mouse drag and wheel moved no state")
    if launches != (r.frames_rendered, 0, 0, 0) \
            or r.frames_rendered < n_frames + 10:
        fail(f"serve {name}: launches {launches} for {r.frames_rendered} "
             "frames rendered")
    log(f"serve {name} result: {json.dumps(res)}")
    # serve()'s self-drive hands out 10 warm-up frames (the first, one per
    # key, one after the mouse) before its timed loop; the drag and the
    # wheel move the state, so the loop's keys can reach states the
    # warm-up never planned.
    t_timed = spy.handed[9]
    timed_misses = [dt for t, dt in spy.misses if t > t_timed]
    # The timed loop's rate without its plan builds (the self-drive's
    # rounded ms_per_frame, less the misses' host time).
    steady_ms = res["ms_per_frame"] - sum(timed_misses) * 1e3 / n_frames
    log(f"[{gpu_line}] serve {name} ({preset.volume.size}^3, "
        f"{preset.camera.width}x{preset.camera.height}, shadow_steps "
        f"{preset.light.shadow_steps}): {res['fps']} fps, "
        f"{res['ms_per_frame']} ms per frame over {n_frames} frames through "
        f"HTTP, warm-up {res['warmup_s']} s, force_dims probe "
        f"{r.probe_seconds:.3f} s (base dims {r.force_dims}), "
        f"{res['plan_cache_misses']} plan-cache misses ({len(timed_misses)} "
        f"in the timed loop, {sum(timed_misses):.3f} s of plan build: "
        f"{steady_ms:.1f} ms per frame without them), PNG "
        f"{res['png_bytes_mean']} bytes mean, {r.frames_rendered} frames "
        f"rendered = K1 launches {launches[0]}, mouse_drag_wheel_ok "
        f"{res['mouse_drag_wheel_ok']}, wall {wall:.2f} s")
    seq, img = spy.served
    az, el, d = spy.states[seq - 1]
    final = res["final_state"]
    at_final = (round(az, 3), round(el, 3), round(d, 3)) == (
        final["azim"], final["elev"], final["dist"])
    plan = r._plan_cache[(round(az, 6), round(el, 6), round(d, 6))]
    with torch.no_grad():
        want = render_image(r.grid, None, r.cfg, r.medium, r.light,
                            plan=plan, backend="sweep")
    plain = plain_frame(r.grid, plan, r.cfg, r.medium, r.light)
    e = check_close(want, plain, f"serve {name} last served frame")
    if not np.array_equal(img, served_uint8(want).cpu().numpy()):
        fail(f"serve {name}: the last served frame (seq {seq}) is not "
             "render_image's at its state and plan")
    levels = int(np.abs(img.astype(np.int32) - served_uint8(plain).cpu()
                        .numpy().astype(np.int32)).max())
    if levels > 1:
        fail(f"serve {name}: the last served frame is {levels} levels from "
             "the plain version's")
    # The loop hands out its newest frame, which may have been dispatched
    # before the last key: hold a frame at the final state itself too.
    final_frame = r.render_frame()
    final_plan = r._plan_cached(r.azim, r.elev, r.dist)
    with torch.no_grad():
        want = render_image(r.grid, None, r.cfg, r.medium, r.light,
                            plan=final_plan, backend="sweep")
    now = r.state()
    if any(now[k] != final[k] for k in ("azim", "elev", "dist")) \
            or not np.array_equal(
            final_frame, served_uint8(want).cpu().numpy()):
        fail(f"serve {name}: the frame at the final state is not "
             "render_image's")
    log(f"serve {name}: last served frame (seq {seq}, state az {az:.4f} el "
        f"{el:.4f} d {d:.4f}, the final state: {at_final}) equals "
        f"render_image bit for bit; {levels} level(s) from the plain "
        f"version's frame (float frame max abs err {e:.3e}); a frame "
        "rendered at the final state equals render_image's too")
    return r, res, launches, e


def in_flight_timings(r, name, gpu_line):
    """On the served renderer: a walk of WALK_STATES azimuth steps opposite
    the served states. First visits: the plan-cache miss (plan build, then
    the frame) and the syncs of each; then, all cached, the syncs of each
    dispatch, a loop of render_frame() (dispatch + fetch each), the
    FrameLoop's pace through next_frame without HTTP (two frames in
    flight), and one frame split into dispatch (host), device, fetch and
    PNG encode (medians over the walk). K1 launches once a frame."""
    from volumetricrenderer_tpu_torch.serve import N_AZ, FrameLoop
    from volumetricrenderer_tpu_torch.utils.image import encode_png
    base = (r._az_idx + N_AZ // 2) % N_AZ

    def goto(k):
        r._az_idx = (base + k % WALK_STATES) % N_AZ

    def state():
        return r.azim, r.elev, r.dist

    reset_counts()
    plan_s, miss_s, miss_syncs, hits = [], [], [], 0
    for k in range(WALK_STATES):
        goto(k)
        key = tuple(round(x, 6) for x in state())
        hits += key in r._plan_cache
        t0 = time.perf_counter()
        plan, syncs = count_syncs(lambda: r._plan_cached(*state()))
        t1 = time.perf_counter()
        r.render_frame()
        t2 = time.perf_counter()
        plan_s.append(t1 - t0)
        miss_s.append(t2 - t0)
        miss_syncs += syncs
    nbytes = plan_bytes(plan)
    cached_syncs = []
    for k in range(WALK_STATES):
        goto(k)
        pending, syncs = count_syncs(r.dispatch_frame)
        pending.fetch()
        cached_syncs += syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(WALK_FRAMES):
        goto(k)
        r.render_frame()
    sync_ms = (time.perf_counter() - t0) / WALK_FRAMES * 1e3

    class Walker:
        frames_rendered = 0

        def dispatch_frame(self):
            goto(self.frames_rendered)
            self.frames_rendered += 1
            return r.dispatch_frame()

    walker = Walker()
    loop = FrameLoop(walker)
    try:
        seq0, _ = loop.next_frame(0, timeout=120)
        t0 = time.perf_counter()
        seq = seq0
        while seq < seq0 + WALK_FRAMES:
            seq, _ = loop.next_frame(seq, timeout=120)
        loop_ms = (time.perf_counter() - t0) / (seq - seq0) * 1e3
    finally:
        loop.stop()
    if loop.thread.is_alive():
        fail(f"{name}: the frame loop did not stop")
    split = {"dispatch": [], "device": [], "fetch": [], "encode": []}
    for k in range(WALK_STATES):
        goto(k)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        pending = r.dispatch_frame()
        t1 = time.perf_counter()
        e1.record()
        img = pending.fetch()
        t2 = time.perf_counter()
        encode_png(img, level=1)
        t3 = time.perf_counter()
        e1.synchronize()
        split["dispatch"].append((t1 - t0) * 1e3)
        split["device"].append(e0.elapsed_time(e1))
        split["fetch"].append((t2 - t1) * 1e3)
        split["encode"].append((t3 - t2) * 1e3)
    torch.cuda.synchronize()
    n_frames = 2 * WALK_STATES + WALK_FRAMES + walker.frames_rendered \
        + WALK_STATES
    walk_launches = path_counts(f"serve {name} walk")
    if walk_launches != (n_frames, 0, 0, 0):
        fail(f"{name} walk: launches {walk_launches} for {n_frames} frames")
    med = {k: statistics.median(v) for k, v in split.items()}
    log(f"[{gpu_line}] serve {name} walk of {WALK_STATES} states: "
        f"plan-cache miss {statistics.median(miss_s) * 1e3:.1f} ms median "
        f"({min(miss_s) * 1e3:.1f}-{max(miss_s) * 1e3:.1f}; plan build "
        f"{statistics.median(plan_s) * 1e3:.1f} ms of it; {hits} of the "
        f"states were cached already), syncs in the misses' plan builds "
        f"{len(miss_syncs)} ({sorted(set(miss_syncs))})")
    log(f"[{gpu_line}] serve {name} cached states: synchronizing calls "
        f"while dispatching {len(cached_syncs)} in {WALK_STATES} frames "
        f"({sorted(set(cached_syncs))}); render_frame() loop "
        f"{sync_ms:.3f} ms per frame; FrameLoop pace (two in flight, no "
        f"HTTP) {loop_ms:.3f} ms per frame over {seq - seq0} frames; split "
        f"of one frame: dispatch (host) {med['dispatch']:.3f} ms, device "
        f"{med['device']:.3f} ms, fetch {med['fetch']:.3f} ms, PNG encode "
        f"{med['encode']:.3f} ms (medians); a plan's device bytes "
        f"{nbytes} ({nbytes * 512 / 2 ** 30:.3f} GiB at the 512-plan cap); "
        f"K1 launches {walk_launches[0]} = frames {n_frames}")
    return {"miss_ms": statistics.median(miss_s) * 1e3,
            "plan_ms": statistics.median(plan_s) * 1e3,
            "syncs_cached": len(cached_syncs), "syncs_miss": len(miss_syncs),
            "sync_ms": sync_ms, "loop_ms": loop_ms, "split": med,
            "plan_bytes": nbytes}


def animate_cells(dev, out_dir, gpu_line):
    """`cli animate --preset config4 --orbit --frames ANIMATE_FRAMES` at
    full width with --video x.apng, counted from 0 (one K1 launch a frame,
    a PNG each), its metrics.jsonl's per-frame seconds and plan seconds,
    frame 0 against render_image with the forced-dims plan (the PNG's
    bytes) and within 1 level of the plain version's frame; then `cli
    animate --preset reference --frames 2`, the per-ray march (no launch).
    The frames go to a temporary directory (eight 1080p PNGs and their
    APNG are larger than --out should hold); metrics.jsonl is kept in
    out_dir. Returns (launches, error)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        return _animate_cells(dev, out_dir, gpu_line, tmp)


def _animate_cells(dev, out_dir, gpu_line, tmp):
    import shutil

    from volumetricrenderer_tpu_torch import PRESETS, cli
    from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep
    from volumetricrenderer_tpu_torch.utils.image import encode_png
    adir = os.path.join(tmp, "config4")
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["animate", "--preset", "config4", "--orbit", "--frames",
                   str(ANIMATE_FRAMES), "--out-dir", adir, "--video",
                   "x.apng"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_counts("cli animate --preset config4 --orbit")
    pngs = [f for f in os.listdir(adir)
            if f.startswith("frame_") and f.endswith(".png")]
    if rc != 0 or launches != (ANIMATE_FRAMES, 0, 0, 0) \
            or len(pngs) != ANIMATE_FRAMES \
            or not os.path.getsize(os.path.join(adir, "x.apng")):
        fail(f"cli animate --preset config4: rc {rc}, launches {launches}, "
             f"{len(pngs)} PNGs")
    shutil.copy(os.path.join(adir, "metrics.jsonl"), os.path.join(
        out_dir, "chip_smoke_animate_config4_metrics.jsonl"))
    with open(os.path.join(adir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    frames = [m for m in lines if "frame" in m]
    dims = tuple(next(m["base_dims"] for m in lines if "base_dims" in m))
    log(f"[{gpu_line}] cli animate --preset config4 --orbit --frames "
        f"{ANIMATE_FRAMES} --video x.apng: wall {wall:.2f} s, base dims "
        f"{dims}, launches {launches}; per frame seconds "
        + ", ".join(f"{m['seconds']:.3f}" for m in frames)
        + " of which plan build " +
        ", ".join(f"{m['plan_seconds']:.3f}" for m in frames))
    p = PRESETS["config4"]
    grid = build_volume(p.volume, device=dev)
    cam = orbit_camera(0.0, fov_y_degrees=p.camera.fov_y_degrees,
                       width=p.camera.width, height=p.camera.height)
    plan = plan_sweep(cam, grid.shape[:3], p.render,
                      supersample=p.render.sweep_supersample,
                      force_base_dims=dims, device=dev)
    with torch.no_grad():
        img = render_image(grid, None, p.render, p.medium, p.light,
                           plan=plan, backend="sweep")
    plain = plain_frame(grid, plan, p.render, p.medium, p.light)
    e = check_close(img, plain, "animate config4 frame 0")

    def u8(x):
        return torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8) \
            .cpu().numpy()
    with open(os.path.join(adir, "frame_00000.png"), "rb") as f:
        if f.read() != encode_png(u8(img)):
            fail("cli animate --preset config4: frame 0 is not render_image"
                 "'s with the forced-dims plan")
    levels = int(np.abs(u8(img).astype(np.int32)
                        - u8(plain).astype(np.int32)).max())
    if levels > 1:
        fail(f"cli animate frame 0 is {levels} levels from the plain "
             "version's")
    log(f"cli animate config4 frame 0 (base {plan.base_shape}) equals "
        f"render_image with the forced-dims plan; {levels} level(s) from "
        f"the plain version's frame (float max abs err {e:.3e})")
    rdir = os.path.join(tmp, "reference")
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["animate", "--preset", "reference", "--frames", "2",
                   "--out-dir", rdir])
    torch.cuda.synchronize()
    ref_launches = path_counts("cli animate --preset reference")
    if rc != 0 or ref_launches != (0, 0, 0, 0) or not os.path.exists(
            os.path.join(rdir, "frame_00001.png")):
        fail(f"cli animate --preset reference: rc {rc}, launches "
             f"{ref_launches}")
    log(f"[{gpu_line}] cli animate --preset reference --frames 2: wall "
        f"{time.perf_counter() - t0:.2f} s, launches {ref_launches} (the "
        "per-ray march)")
    return launches, e


def front_end(dev, out_dir, gpu_line):
    """Step 21: the viewer front end on the card (serve_cell,
    in_flight_timings and animate_cells). Returns ([launch tuples of the
    counted paths], [errors of K1's frames])."""
    paths, errs = [], []
    for name, n_frames in SERVE_RUNS:
        r, _, launches, e = serve_cell(name, n_frames, gpu_line)
        paths.append(launches)
        errs.append(e)
        in_flight_timings(r, name, gpu_line)
        del r
    launches, e = animate_cells(dev, out_dir, gpu_line)
    paths.append(launches)
    errs.append(e)
    return paths, errs


# Step 22: the slab-sharded sweep (parallel/). Config 5 (config.py
# PRESETS["config5"]: a 512^3 FBM cloud at 1920x1080, emission, density
# 8); the in-process slab splits (slabs, data ranks); the JAX sharded
# tests' tolerances (tests/test_sweep_sharded.py): maps 2e-4 with the
# early-stop gate off, gradients rtol 1e-3, atol 1e-3 * max, a gated frame
# within 20 eps.
SHARD_SPLITS = ((2, 1), (2, 2), (4, 1), (4, 2))
SHARD_MAP_TOL, SHARD_GRAD_TOL, SHARD_GATE_EPS = 2e-4, 1e-3, 1e-3
SHARD_STEPS = 3
# (n_slab, n_data, slab, data): one block of each split, held to the plain
# versions (256 or 128 slices, 1536 or 768 base rows at config 5)
CONFIG5_PLAIN_BLOCKS = ((2, 1, 1, 0), (2, 2, 0, 1), (4, 1, 2, 0),
                        (4, 2, 3, 1))


class GeneralSpy:
    """Counts the calls of the general sweep (ops/sweep._sweep_base, by its
    `general_calls` counter) for the time of a `with` block."""

    def __enter__(self):
        self.start, self.calls = ops_sweep.general_calls, 0
        return self

    def __exit__(self, *exc):
        self.calls = ops_sweep.general_calls - self.start


def check_split(label, grid, plan, cfg, medium, n_slab, n_data, want,
                want_grads, cts, fwd_mod, bwd_mod, scroll=None, lvol=None):
    """One split: its frame's maps and its gradients on seeded cotangents
    (grid, and light volume if given) against the unsharded kernels', the
    launch counts set to 0 before the forward and before the backward and
    read after each (n_slab * n_data launches of each kernel). Returns
    (launches fwd, launches bwd, maps error, gradient errors)."""
    k_f = list(KERNELS).index(fwd_mod)
    k_b = list(KERNELS).index(bwd_mod)
    g = grid.detach().clone().requires_grad_()
    lv = None if lvol is None else lvol.detach().clone().requires_grad_()
    reset_counts()
    maps = split_sweep(g, plan, cfg, medium, n_slab, n_data, scroll, lv)
    torch.cuda.synchronize()
    launches_f = path_counts(f"{label} split {n_slab}x{n_data} forward")
    reset_counts()
    sum((m * c).sum() for m, c in zip(maps[:3], cts)).backward()
    torch.cuda.synchronize()
    launches_b = path_counts(f"{label} split {n_slab}x{n_data} backward")
    n = n_slab * n_data
    if launches_f[k_f] != n or sum(launches_f) != n \
            or launches_b[k_b] != n or sum(launches_b) != n:
        fail(f"{label} split {n_slab}x{n_data}: launches {launches_f} "
             f"forward, {launches_b} backward, expected {n} of {fwd_mod} "
             f"and of {bwd_mod}")
    e_maps = 0.0
    maps = [m.detach() for m in maps]
    for got_m, want_m, name in zip(maps, want, ("acc", "trans", "wsum",
                                                 "hit")):
        if not torch.allclose(got_m, want_m, rtol=SHARD_MAP_TOL,
                              atol=SHARD_MAP_TOL):
            fail(f"{label} split {n_slab}x{n_data} {name}: max abs err "
                 f"{max_err(got_m, want_m):.3e} against the unsharded kernel")
        e_maps = max(e_maps, max_err(got_m, want_m))
    e_grads = [check_grad(got.grad, w, f"{label} split {n_slab}x{n_data} "
                          f"gradient", tol=SHARD_GRAD_TOL)[0]
               for got, w in zip((g, lv), want_grads) if w is not None]
    log(f"{label} split {n_slab} slabs x {n_data} data ranks: launches "
        f"{launches_f} forward, {launches_b} backward; maps max abs err "
        f"{e_maps:.3e}, gradients {', '.join(f'{e:.3e}' for e in e_grads)}")
    return launches_f, launches_b, e_maps, e_grads


def unsharded_grads(grid, plan, cfg, medium, cts, scroll=None, lvol=None):
    """The unsharded kernels' maps, and the gradients of sum(maps * cts)
    to the grid (and the light volume)."""
    g = grid.detach().clone().requires_grad_()
    lv = None if lvol is None else lvol.detach().clone().requires_grad_()
    if g.dim() == 4:
        maps = sweep_ref_fwd.sweep_base_ref(
            g.permute(plan.perm + (3,)), plan, cfg, medium, scroll=scroll,
            lperm=None if lv is None else lv.permute(plan.perm))
    else:
        maps = sweep_fwd.sweep_base(
            g.permute(plan.perm), plan, cfg, medium,
            lperm=None if lv is None else lv.permute(plan.perm))
    sum((m * c).sum() for m, c in zip(maps[:3], cts)).backward()
    torch.cuda.synchronize()
    return ([m.detach() for m in maps],
            (g.grad, None if lv is None else lv.grad))


def hold_to_plain(name, maps, want, dg, want_dg):
    """A kernel's maps and dG against its plain version's at step 22's
    tolerances; returns (maps error, gradient error)."""
    e_m = 0.0
    for got_m, want_m, m in zip(maps, want, ("acc", "trans", "wsum", "hit")):
        if not torch.allclose(got_m, want_m, rtol=SHARD_MAP_TOL,
                              atol=SHARD_MAP_TOL):
            fail(f"{name} {m}: kernel and plain version disagree, max abs "
                 f"err {max_err(got_m, want_m):.3e}")
        e_m = max(e_m, max_err(got_m, want_m))
    e_g = check_grad(dg, want_dg, f"{name} gradient", tol=SHARD_GRAD_TOL)[0]
    log(f"{name}: kernel against plain version: maps max abs err "
        f"{e_m:.3e}, gradient {e_g:.3e}")
    return e_m, e_g


def plain_whole(g3, plan, cfg, medium, cts, want, want_g):
    """The unsharded K1/K2 maps and grid gradient that every config5 split
    is held to (unsharded_grads), against the plain versions on the whole
    stack with the early-stop gate off (cfg)."""
    with torch.no_grad():
        (stack, *args), flip = sweep_fwd.sweep_inputs(g3.permute(plan.perm),
                                                      plan, cfg, medium)
        kw = dict(emission=cfg.emission, flip=flip,
                  address_mode=cfg.address_mode)
        pm = sweep_fwd.sweep_fwd_reference(stack, *args, **kw)
        pg = sweep_bwd.sweep_bwd_reference(stack, *args, *cts, pm[1], pm[2],
                                           **kw)
    torch.cuda.synchronize()
    return hold_to_plain(
        f"config5 unsharded, {plan.slice_z.shape[0]} slices x "
        f"{plan.base_shape[0]} rows", want, pm,
        want_g[0].permute(plan.perm), pg)


def plain_blocks(label, grid, plan, cfg, medium, cts, blocks, scroll=None):
    """K1/K2 (a 3-D grid) or K4/K5 (4 channels) against their plain
    versions on the blocks (n_slab, n_data, slab, data) that the splits
    give them (split_inputs): the block's slices and rows, the gate off in
    cfg, the block's rows of the seeded cotangents and the forward
    kernel's own trans and wsum. Comparison launches, outside every
    counted path. Returns (maps errors, gradient errors)."""
    from volumetricrenderer_tpu_torch.parallel.sweep_sharded import \
        split_inputs
    lt, em = LightConfig(), cfg.emission
    e_m, e_g = [], []
    for n_slab, n_data, s, d in blocks:
        with torch.no_grad():
            stack, chan, _, lp = split_inputs(grid, plan, cfg, medium,
                                              n_slab, s, n_data, d, scroll)
            c = [x[lp.r0:lp.r1].contiguous() for x in cts]
            if chan is not None:
                offs = sweep_ref_fwd._channel_offsets(
                    medium, scroll, plan.coord_order, device=grid.device)
                L = (chan.flip(0) if plan.sign < 0 else chan).contiguous()
                inputs = (L, lp.slice_z, lp.v_grid, plan.u_grid, lp.seglen,
                          sweep_ref_fwd._params_ref(plan, cfg, medium, lt,
                                                    offs))
                maps = sweep_ref_fwd.launch_kernel(*inputs, em)
                dg = sweep_ref_bwd.launch_kernel(*inputs, *c, maps[1],
                                                 maps[2], emission=em)
                want = sweep_ref_fwd.sweep_ref_fwd_reference(*inputs,
                                                             emission=em)
                want_dg = sweep_ref_bwd.sweep_ref_bwd_reference(
                    *inputs, *c, maps[1], maps[2], emission=em)
            else:
                flip, wrap = plan.sign < 0, cfg.address_mode == "wrap"
                kw = dict(emission=em, flip=flip,
                          address_mode=cfg.address_mode)
                inputs = (stack.contiguous(), lp.slice_z, lp.v_grid,
                          plan.u_grid, lp.seglen,
                          sweep_fwd._params_for(plan, cfg, medium, lt))
                maps = sweep_fwd.launch_kernel(*inputs, em, flip, wrap)
                dg = sweep_bwd.launch_kernel(*inputs, *c, maps[1], maps[2],
                                             em, flip, wrap)
                want = sweep_fwd.sweep_fwd_reference(*inputs, **kw)
                want_dg = sweep_bwd.sweep_bwd_reference(
                    *inputs, *c, maps[1], maps[2], **kw)
        torch.cuda.synchronize()
        e = hold_to_plain(
            f"{label} split {n_slab}x{n_data} block (slab {s}, data {d}), "
            f"{lp.slice_z.shape[0]} slices x {lp.r1 - lp.r0} rows",
            maps.unbind(0), want, dg, want_dg)
        e_m.append(e[0])
        e_g.append(e[1])
    return e_m, e_g


def seeded_cts(plan, seed, dev):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=plan.base_shape),
                         dtype=torch.float32, device=dev) for _ in range(3)]


def config5_mesh_phase(dev, grid5, cam, plan, cfg, medium, light, out_dir,
                       gpu_line):
    """(a) config 5 through a 1x1 NCCL mesh (world size 1): the sharded
    frame equal to render_image bit for bit, the n_slices=128 frame, three
    sharded train steps; (e) their timings and a torch.profiler table of
    the step. Returns (launch tuples, timings)."""
    from volumetricrenderer_tpu_torch.parallel import bootstrap
    from volumetricrenderer_tpu_torch.parallel.mesh import make_mesh
    from volumetricrenderer_tpu_torch.parallel.sweep_sharded import (
        make_sweep_train_step, sweep_render_sharded)
    import torch.distributed as dist
    paths, t = [], {}
    if not bootstrap.initialize_distributed(
            coordinator_address=f"localhost:{free_port()}", num_processes=1,
            process_id=0, retries=1, device=dev.type):
        fail("initialize_distributed started no process group")
    try:
        mesh = make_mesh(1, 1, device=dev.type)
        log(f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, backend "
            f"{dist.get_backend()}, {bootstrap.process_summary()}")
        frames = []
        for label, p in (("config5 1x1 sharded frame", plan),
                         ("config5 1x1 sharded frame, 128 slices",
                          plan_for(cam, grid5.shape[:3], cfg, n_slices=128,
                                   device=dev))):
            reset_counts()
            img = sweep_render_sharded(grid5, p, mesh, cfg, medium, light)
            torch.cuda.synchronize()
            launches = path_counts(label)
            if launches != (1, 0, 0, 0):
                fail(f"{label}: launches {launches}, expected (1, 0, 0, 0)")
            paths.append(launches)
            want = render_image(grid5, cam, cfg, medium, light, plan=p)
            if tuple(img.shape) != (cam.height, cam.width, 4) or \
                    not bool(torch.isfinite(img).all()) or \
                    not float(img[..., 3].max()) > 0.0:
                fail(f"{label}: shape {tuple(img.shape)}, not finite or "
                     "empty")
            if not torch.equal(img, want):
                fail(f"{label}: not render_image's frame bit for bit, max "
                     f"abs err {max_err(img, want):.3e}")
            log(f"{label}: base {p.base_shape}, {p.slice_z.shape[0]} slices, "
                f"axis {p.axis} sign {p.sign:+d}: equal to render_image bit "
                f"for bit; alpha mean {float(img[..., 3].mean()):.4f}")
            frames.append(img)
        g = torch.full(grid5.shape[:3], 0.1, device=dev)
        step, _ = make_sweep_train_step(mesh, plan, cfg, medium, g, light,
                                        learning_rate=FIT_LR)
        target = frames[0][..., :3].contiguous()
        reset_counts()
        losses = [step(target) for _ in range(SHARD_STEPS)]
        torch.cuda.synchronize()
        launches = path_counts("config5 1x1 sharded train step")
        if launches != (SHARD_STEPS, SHARD_STEPS, 0, 0):
            fail(f"config5 sharded train step: launches {launches}, expected "
                 f"({SHARD_STEPS}, {SHARD_STEPS}, 0, 0)")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            fail(f"config5 sharded train step did not descend: {losses}")
        paths.append(launches)
        log(f"config5 1x1 sharded train step: losses "
            f"{[f'{x:.6e}' for x in losses]}, launches {launches}, grid in "
            f"[{float(g.detach().min()):.4f}, "
            f"{float(g.detach().max()):.4f}]")
        t["render_ms"] = cuda_ms(lambda: render_image(grid5, cam, cfg, medium,
                                                      light, plan=plan))
        t["sharded_ms"] = cuda_ms(lambda: sweep_render_sharded(
            grid5, plan, mesh, cfg, medium, light))
        t["step_ms"] = cuda_ms(lambda: step(target))
        rays = cam.width * cam.height
        log(f"[{gpu_line}] config5 512^3 at {cam.width}x{cam.height}, base "
            f"{plan.base_shape}, {plan.slice_z.shape[0]} slices:")
        log(f"  render_image (unsharded)        {t['render_ms']:.3f} ms = "
            f"{rays / (t['render_ms'] * 1e-3):.4g} forward rays/s")
        log(f"  sweep_render_sharded, 1x1 mesh  {t['sharded_ms']:.3f} ms "
            f"({t['sharded_ms'] / t['render_ms']:.4f} of unsharded)")
        log(f"  sharded train step (Adam, clamp) {t['step_ms']:.3f} ms")
        with torch.no_grad():
            maps = sweep_fwd.sweep_base(grid5[..., 0].permute(plan.perm),
                                        plan, cfg, medium)
        measure_warp.warp_timings(maps, plan, cfg, medium, light, log=log)
        profile_fwdbwd(lambda: step(target), out_dir,
                       "chip_smoke_profile_config5.txt")
    finally:
        dist.destroy_process_group()
        bootstrap._initialized = False
    return paths, t


def split_timings(grid5, plan, cfg, medium, gpu_line):
    """(e) each local K1 and K2 of the (4, 1) and (2, 2) splits at config5
    and their shares of the bound, beside the unsharded kernels; the
    composite of two base-map tuples."""
    from volumetricrenderer_tpu_torch.ops.sweep import composite_base_maps
    from volumetricrenderer_tpu_torch.parallel.sweep_sharded import \
        split_inputs
    from volumetricrenderer_tpu_torch.kernels.sweep_fwd import _params_for
    params = _params_for(plan, cfg, medium, LightConfig())
    cts = seeded_cts(plan, 21, grid5.device)
    flip = plan.sign < 0

    def timed(stack, p, lp_slice, v, seglen, rows):
        stack = stack.contiguous()
        args = (stack, lp_slice, v, p.u_grid, seglen, params)
        maps = sweep_fwd.launch_kernel(*args, cfg.emission, flip, False)
        c = [x[rows] for x in cts]
        f_ms = cuda_ms(lambda: sweep_fwd.launch_kernel(*args, cfg.emission,
                                                       flip, False))
        b_ms = cuda_ms(lambda: sweep_bwd.launch_kernel(
            *args, *c, maps[1], maps[2], cfg.emission, flip, False))
        local = dataclasses.replace(p, slice_z=lp_slice, v_grid=v)
        samples, lines = inbox_samples(local)
        b_f = bound("sweep_fwd", samples, lines, (*args, maps))[0]
        b_b = bound("sweep_bwd", samples, lines,
                    (*args, c[1], c[2], maps[1], maps[2], stack))[0]
        return f_ms, b_ms, b_f, b_b, maps

    g3 = grid5[..., 0]
    whole = timed(g3.permute(plan.perm), plan, plan.slice_z, plan.v_grid,
                  plan.seglen, slice(None))
    log(f"[{gpu_line}] config5 unsharded K1 {whole[0]:.3f} ms (share of its "
        f"bound {whole[2] / whole[0]:.4f}), K2 {whole[1]:.3f} ms "
        f"({whole[3] / whole[1]:.4f})")
    out = {"k1_ms": whole[0], "k2_ms": whole[1]}
    for n_slab, n_data in ((4, 1), (2, 2)):
        f_sum = b_sum = 0.0
        for d in range(n_data):
            for s in range(n_slab):
                stack, _, _, lp = split_inputs(g3, plan, cfg, medium, n_slab,
                                               s, n_data, d)
                f_ms, b_ms, b_f, b_b, _ = timed(
                    stack, plan, lp.slice_z, lp.v_grid, lp.seglen,
                    slice(lp.r0, lp.r1))
                f_sum, b_sum = f_sum + f_ms, b_sum + b_ms
                log(f"[{gpu_line}] config5 split {n_slab}x{n_data} block "
                    f"(slab {s}, data {d}): K1 {f_ms:.3f} ms (share "
                    f"{b_f / f_ms:.4f}), K2 {b_ms:.3f} ms (share "
                    f"{b_b / b_ms:.4f})")
        log(f"[{gpu_line}] config5 split {n_slab}x{n_data}: local K1 sum "
            f"{f_sum:.3f} ms ({f_sum / whole[0]:.4f} of unsharded), local "
            f"K2 sum {b_sum:.3f} ms ({b_sum / whole[1]:.4f})")
        out[f"k1_sum_{n_slab}x{n_data}"] = f_sum
        out[f"k2_sum_{n_slab}x{n_data}"] = b_sum
    maps = tuple(whole[4].unbind(0))
    out["composite_ms"] = cuda_ms(lambda: composite_base_maps(maps, maps))
    log(f"[{gpu_line}] composite_base_maps of two {plan.base_shape} map "
        f"tuples: {out['composite_ms']:.3f} ms")
    return out


def repaired_on_the_card(dev):
    """(d) The configurations the port once refused, at small shapes, on the
    card against the same call on the CPU: the general sweep launches no
    kernel; a light volume with absorption is dropped and the kernel
    sweeps. Returns the errors."""
    rng = np.random.default_rng(31)
    grid4 = rng.uniform(0.1, 1.0, (16, 16, 16, 4)).astype(np.float32)
    scroll = rng.uniform(-1.5, 1.5, (4, 3)).astype(np.float32)
    lvol = rng.uniform(0.0, 1.0, (16, 16, 16)).astype(np.float32)
    cases = [
        ("reference, clamp", grid4, RenderConfig(
            emission=True, quadrature="sliced", address_mode="clamp"),
         MediumConfig(density=4.0), scroll, None, True),
        ("reference, wrap", grid4, RenderConfig(
            emission=True, quadrature="sliced", address_mode="wrap"),
         MediumConfig(density=4.0), scroll, None, True),
        ("light volume of another shape", grid4[..., 0].copy(),
         RenderConfig(emission=True, quadrature="sliced"),
         MediumConfig(combine="single", density=8.0), None,
         lvol[2:14, :, 3:13].copy(), True),
        ("absorption with a light volume", grid4[..., 0].copy(),
         RenderConfig(emission=False, quadrature="sliced"),
         MediumConfig(combine="single", density=8.0), None, lvol, False),
    ]
    errs = []
    cam = make_camera(CameraConfig(eye=SMALL_EYES[0][0], width=96,
                                   height=64))
    for name, grid, cfg, medium, sc, lv, general in cases:
        def call(d):
            def t(x):
                return None if x is None else torch.from_numpy(x).to(d)
            p = plan_for(cam, grid.shape[:3], cfg, device=d)
            return sweep_render(t(grid), p, cfg, medium, scroll=t(sc),
                                light_volume=t(lv))
        with GeneralSpy() as spy:
            reset_counts()
            got = call(dev)
            torch.cuda.synchronize()
            launches = counts()
        want = call("cpu")
        if bool(spy.calls) != general or sum(launches) != (0 if general
                                                           else 1):
            fail(f"repaired {name}: {spy.calls} general sweeps, launches "
                 f"{launches}")
        e = max_err(got.cpu(), want)
        if not torch.allclose(got.cpu(), want, rtol=RTOL, atol=1e-4):
            fail(f"repaired {name}: the card's frame and the CPU's differ by "
                 f"{e:.3e}")
        errs.append(e)
        log(f"repaired {name}: {'general sweep' if general else 'kernel'} "
            f"({spy.calls} general sweeps, launches {launches}); the card's "
            f"frame against the CPU's: max abs err {e:.3e}")
    return errs


# Step 22c: two ranks sharing the one card. NCCL refuses two ranks on one
# device (a probe, run first, shows whether this build does); on that
# refusal alone the ranks then run on gloo, which exchanges the CUDA maps
# through host copies that parallel/mesh.py makes.
SHARED_CARD_RANKS = 2
SHARED_CARD_TIMEOUT_S = 240
NCCL_REFUSAL = "Duplicate GPU detected"


def _shared_card_rank(rank, world, backend, init_file, out_file):
    """One rank of a (1, world) mesh on cuda:0: config 5's frame and the
    gradient of sum(rgb^2) to its slab block, sweep_render_sharded through
    K1 and K2 on the block; rank 0 holds them to the unsharded kernels'
    (gate off: 2e-4 and 1e-3 of the maximum) and writes the result."""
    import torch.distributed as dist
    from volumetricrenderer_tpu_torch import get_preset
    from volumetricrenderer_tpu_torch.parallel.mesh import make_mesh
    from volumetricrenderer_tpu_torch.parallel.sweep_sharded import \
        sweep_render_sharded
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        probe = torch.ones(4, device=dev)
        if backend == "nccl":
            dist.all_reduce(probe)
            torch.cuda.synchronize()
        mesh = make_mesh(1, world, device="cuda" if backend == "nccl"
                         else "cpu")
        preset = get_preset("config5")
        cfg = dataclasses.replace(preset.render,
                                  early_stop_transmittance=-1.0)
        medium = preset.medium
        grid = build_volume(preset.volume, device=dev)[..., 0]
        torch.cuda.empty_cache()
        cam = make_camera(preset.camera)
        plan = plan_for(cam, grid.shape, cfg, device=dev)
        depth = grid.shape[0] // world
        block = grid[rank * depth:(rank + 1) * depth].clone() \
            .requires_grad_()
        reset_counts()
        t0 = time.perf_counter()
        img = sweep_render_sharded(block, plan, mesh, cfg, medium)
        (img[..., :3] ** 2).sum().backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts()
        rows = [None] * world
        dist.all_gather_object(rows, launches)
        if rank == 0:
            g = grid.clone().requires_grad_()
            want = render_image(g, cam, cfg, medium, plan=plan)
            (want[..., :3] ** 2).sum().backward()
            scale = float(g.grad.abs().max())
            res = {"launches": rows, "seconds": seconds,
                   "image_err": max_err(img.detach(), want.detach()),
                   "grad_err": max_err(block.grad, g.grad[:depth]),
                   "grad_scale": scale,
                   "image_ok": bool(torch.allclose(
                       img.detach(), want.detach(), rtol=SHARD_MAP_TOL,
                       atol=SHARD_MAP_TOL)),
                   "grad_ok": bool(torch.allclose(
                       block.grad, g.grad[:depth], rtol=SHARD_GRAD_TOL,
                       atol=SHARD_GRAD_TOL * scale))}
            with open(out_file, "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_shared_card(backend, tmp):
    """Spawn SHARED_CARD_RANKS ranks of _shared_card_rank on `backend`;
    returns (result dict or None, the error text or None). The ranks are
    ended after SHARED_CARD_TIMEOUT_S."""
    import torch.multiprocessing as mp
    init_file = os.path.join(tmp, f"init-{backend}")
    out_file = os.path.join(tmp, f"out-{backend}.json")
    ctx = mp.start_processes(
        _shared_card_rank, args=(SHARED_CARD_RANKS, backend, init_file,
                                 out_file),
        nprocs=SHARED_CARD_RANKS, join=False, start_method="spawn")
    deadline = time.perf_counter() + SHARED_CARD_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                return None, (f"no result after {SHARED_CARD_TIMEOUT_S} s; "
                              "ranks ended")
    except Exception as e:  # a rank raised: its traceback is the message
        return None, str(e)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    with open(out_file) as f:
        return json.load(f), None


def shared_card_phase(out_dir):
    """(c) Two ranks on the one card: the NCCL probe, then, only if NCCL
    refused two ranks on one device (NCCL_REFUSAL), the ranks on gloo (a
    required phase: it fails the script on any other NCCL error, at the
    time limit, or if the ranks do not agree with the unsharded kernels).
    Returns the launch tuples of the ranks' path."""
    import tempfile
    # The ranks build config 5's volume on the card together (~22 GB each
    # at its peak): this process gives back the blocks its cache holds.
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        res, err = run_shared_card("nccl", tmp)
        if res is None:
            # Only NCCL's refusal of two ranks on one device sends the
            # ranks to gloo; any other fault (or the time limit) fails.
            if NCCL_REFUSAL not in err:
                fail(f"shared card on NCCL: {err}")
            line = next(ln for ln in err.splitlines() if NCCL_REFUSAL in ln)
            log(f"shared card, NCCL with {SHARED_CARD_RANKS} ranks on "
                f"cuda:0 refused: {line.strip()}")
            res, err = run_shared_card("gloo", tmp)
            backend = "gloo (host copies)"
            if res is None:
                fail(f"shared card on gloo: {err}")
        else:
            backend = "nccl"
    want = [(1, 1, 0, 0)] * SHARED_CARD_RANKS
    if [tuple(r) for r in res["launches"]] != want or not res["image_ok"] \
            or not res["grad_ok"]:
        fail(f"shared card on {backend}: {res}")
    log(f"shared card, {SHARED_CARD_RANKS} ranks on cuda:0 over {backend}: "
        f"config5 frame and backward in {res['seconds']:.3f} s (rank 0's "
        f"host clock), launches per rank {res['launches']}, frame max abs "
        f"err {res['image_err']:.3e}, gradient {res['grad_err']:.3e} at "
        f"max {res['grad_scale']:.3e}")
    return [tuple(r) for r in res["launches"]]


def sharded_phase(dev, out_dir, gpu_line):
    """Step 22: the slab-sharded sweep (parallel/) on the card. Returns
    ([launch tuples of the counted paths], {kernel: [errors]}, timings)."""
    from volumetricrenderer_tpu_torch import get_preset
    t_phase = time.perf_counter()
    preset = get_preset("config5")
    cfg, medium, light = preset.render, preset.medium, preset.light
    t0 = time.perf_counter()
    grid5 = build_volume(preset.volume, device=dev)
    torch.cuda.synchronize()
    log(f"config5 volume {tuple(grid5.shape)}: {time.perf_counter() - t0:.2f}"
        " s")
    cam = make_camera(preset.camera)
    t0 = time.perf_counter()
    plan = plan_for(cam, grid5.shape[:3], cfg, device=dev)
    torch.cuda.synchronize()
    log(f"config5 plan: {time.perf_counter() - t0:.3f} s of host")
    errs = {name: [] for name in KERNELS}
    with GeneralSpy() as spy:
        # (a) the 1x1 NCCL mesh at full width
        paths, t = config5_mesh_phase(dev, grid5, cam, plan, cfg, medium,
                                      light, out_dir, gpu_line)
        # (b) the slab split in one process: config 5
        cfg_off = dataclasses.replace(cfg, early_stop_transmittance=-1.0)
        g3 = grid5[..., 0]
        cts = seeded_cts(plan, 17, dev)
        want, want_g = unsharded_grads(g3, plan, cfg_off, medium, cts)
        # K1/K2 against their plain versions at the shapes of this path:
        # the whole stack the splits are held to, one block of each split
        e_m, e_g = plain_whole(g3, plan, cfg_off, medium, cts, want, want_g)
        errs["sweep_fwd"].append(e_m)
        errs["sweep_bwd"].append(e_g)
        e_m, e_g = plain_blocks("config5", g3, plan, cfg_off, medium, cts,
                                CONFIG5_PLAIN_BLOCKS)
        errs["sweep_fwd"] += e_m
        errs["sweep_bwd"] += e_g
        for n_slab, n_data in SHARD_SPLITS:
            lf, lb, e_m, e_g = check_split(
                "config5", g3, plan, cfg_off, medium, n_slab, n_data, want,
                want_g, cts, "sweep_fwd", "sweep_bwd")
            paths += [lf, lb]
            errs["sweep_fwd"].append(e_m)
            errs["sweep_bwd"] += e_g
        # the preset's own gate: within 20 eps of the unsharded frame
        reset_counts()
        with torch.no_grad():
            maps = split_sweep(g3, plan, cfg, medium, 4, 1)
        torch.cuda.synchronize()
        paths.append(path_counts("config5 split 4x1, the preset's gate"))
        gated = finish_image(maps, plan, cfg, medium, light)
        whole = render_image(grid5, cam, cfg, medium, light, plan=plan)
        e_gate = max_err(gated, whole)
        if not e_gate < 20 * SHARD_GATE_EPS:
            fail(f"config5 gated split: max abs err {e_gate:.3e} against the "
                 f"unsharded frame, above 20 eps")
        log(f"config5 split 4x1 with the gate at "
            f"{cfg.early_stop_transmittance}: frame max abs err "
            f"{e_gate:.3e} against the unsharded frame (bound 20 eps = "
            f"{20 * SHARD_GATE_EPS})")
        # the reference preset through K4/K5, a seeded scroll
        grid4 = build_volume(VolumeConfig(), device=dev)
        cfg4 = RenderConfig(emission=True, quadrature="sliced",
                            early_stop_transmittance=-1.0)
        med4 = MediumConfig()
        cam4 = make_camera(CameraConfig(width=REF_WIDTH, height=REF_HEIGHT))
        plan4 = plan_for(cam4, grid4.shape[:3], cfg4, device=dev)
        scroll = seeded_scroll(REF_SCROLL_SEEDS[0], dev)
        cts4 = seeded_cts(plan4, 18, dev)
        want4, want4_g = unsharded_grads(grid4, plan4, cfg4, med4, cts4,
                                         scroll)
        e_m, e_g = plain_blocks("reference preset", grid4, plan4, cfg4, med4,
                                cts4, ((4, 2, 1, 1),), scroll)
        errs["sweep_ref_fwd"] += e_m
        errs["sweep_ref_bwd"] += e_g
        for n_slab, n_data in ((2, 1), (4, 2)):
            lf, lb, e_m, e_g = check_split(
                "reference preset", grid4, plan4, cfg4, med4, n_slab, n_data,
                want4, want4_g, cts4, "sweep_ref_fwd", "sweep_ref_bwd",
                scroll)
            paths += [lf, lb]
            errs["sweep_ref_fwd"].append(e_m)
            errs["sweep_ref_bwd"] += e_g
        # a small shadowed case through the kernels' light branch
        gs = cloud_volume(32, 7, device=dev)
        lt = LightConfig(shadow_steps=16)
        lvol = light_transmittance_volume(gs, lt, cfg_off, medium)
        ps = plan_for(make_camera(CameraConfig(eye=SMALL_EYES[4][0],
                                               width=96, height=64)),
                      gs.shape, cfg_off, device=dev)
        ctss = seeded_cts(ps, 19, dev)
        wants, wants_g = unsharded_grads(gs, ps, cfg_off, medium, ctss,
                                         lvol=lvol)
        lf, lb, e_m, e_g = check_split(
            "shadowed 32^3", gs, ps, cfg_off, medium, 2, 2, wants, wants_g,
            ctss, "sweep_fwd", "sweep_bwd", lvol=lvol)
        paths += [lf, lb]
        errs["sweep_fwd"].append(e_m)
        errs["sweep_bwd"] += e_g
    if spy.calls:
        fail(f"the sharded main paths called the general sweep {spy.calls} "
             "times")
    log("sharded main paths: 0 calls of the general sweep")
    # (c) two ranks sharing the card
    paths += shared_card_phase(out_dir)
    # (d) the repaired configurations
    errs_d = repaired_on_the_card(dev)
    log(f"repaired configurations on the card: max abs err {max(errs_d):.3e}")
    # (e) timings of the split
    t.update(split_timings(grid5, plan, cfg, medium, gpu_line))
    log(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return paths, errs, t


# Step 23: the port's north-star bench as a user runs it (bench_torch.py, a
# process of its own, at full width) on the libraries step 2 built.
BENCH_TIMEOUT_S = 300
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "volume", "image",
    "grad_allclose_vs_reference", "ms_per_frame_fwd_bwd",
    "ms_per_frame_fwd_bwd_quartiles", "host_ms_per_frame_fwd_bwd",
    "kernels_vs_general", "ms_per_frame_general", "ms_per_frame_bf16",
    "bf16_speedup", "device", "power_limit_w", "early_exit_rate_flagship",
    "early_exit_rate_dense", "base_shape", "timed_runs", "warmup_runs",
    "peak_memory_gib", "launches_per_step", "general_sweep_calls",
    "bench_total_s")
BENCH_LAUNCHES = {"fwd_bwd": {"sweep_fwd": 1, "sweep_bwd": 1},
                  "bf16": {"sweep_fwd": 1, "sweep_bwd": 1}}
# The two routes to the dense exit rate (the general sweep in the bench, K1
# here) differ in their sum order only: a pixel may cross the threshold.
EXIT_RATE_TOL = 1e-4
# BENCH_r05.json early_exit_rate_dense, the TPU v5e's: its general sweep ran
# its matmuls at default (bfloat16-pass) precision, so it is shown, not held.
TPU_DENSE_RATE = 0.0241


def _libraries():
    from volumetricrenderer_tpu_torch.kernels import build
    return {f for f in os.listdir(build.BUILD_DIR) if f.endswith(".so")}


def bench_phase(grid, plan, cfg, medium, out_dir, gpu_line):
    """Runs `python3 bench_torch.py` with no size override in a process of
    its own, which must load the libraries this run built (no new one may
    appear), and holds its last line: every key, the flagship's sizes, the
    gradient check passed, one K1 and one K2 launch per headline and
    bfloat16 step, no general sweep on those steps and some on the general
    sweep's A/B and the exit rates, no flagship ray ended early; and the
    dense exit rate (the general sweep, in the bench) against the same rate
    from K1's trans map on the same grid and plan here, within
    EXIT_RATE_TOL. Returns the line."""
    t0 = time.perf_counter()
    before = _libraries()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("VOLT_BENCH_")}
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    with open(os.path.join(out_dir, "bench_torch_stderr.txt"), "w") as f:
        f.write(proc.stderr)
    for line in proc.stderr.strip().splitlines():
        log(f"  bench_torch.py: {line}")
    if proc.returncode != 0:
        fail(f"bench_torch.py exited with {proc.returncode}")
    built = sorted(_libraries() - before)
    if built:
        fail(f"bench_torch.py built {built} instead of loading this run's "
             "libraries")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"bench_torch.py line: {json.dumps(res)}")
    missing = [k for k in BENCH_KEYS if k not in res]
    if missing:
        fail(f"bench_torch.py: the line lacks {missing}")
    if (res["volume"], res["image"]) != (VOLUME, [WIDTH, HEIGHT]) \
            or res["device"] != torch.cuda.get_device_name(0):
        fail(f"bench_torch.py ran {res['volume']}^3 at {res['image']} on "
             f"{res['device']}")
    if res["grad_allclose_vs_reference"] is not True:
        fail("bench_torch.py: the gradient check failed")
    if res["launches_per_step"] != BENCH_LAUNCHES:
        fail(f"bench_torch.py launches per step {res['launches_per_step']}, "
             f"expected {BENCH_LAUNCHES}")
    calls = res["general_sweep_calls"]
    if calls["fwd_bwd"] or calls["bf16"] or not calls["general"] > 0 \
            or not calls["exit_rate"] > 0:
        fail(f"bench_torch.py general sweep calls {calls}: none expected on "
             "the kernels' steps, some on the A/B and the exit rates")
    if res["early_exit_rate_flagship"] != 0.0:
        fail("bench_torch.py: flagship rays ended early (rate "
             f"{res['early_exit_rate_flagship']})")
    # the dense rate from K1's trans map (a comparison launch, no main path)
    with torch.no_grad():
        trans = sweep_fwd.sweep_base(
            grid.permute(plan.perm) * bench.DENSE, plan, cfg,
            dataclasses.replace(medium, density=1.0))[1]
    rate_k1 = float((trans <= cfg.early_stop_transmittance)
                    .to(torch.float32).mean())
    diff = abs(rate_k1 - res["early_exit_rate_dense"])
    log(f"early-exit rate at density {bench.DENSE:g}: general sweep "
        f"(bench_torch.py) {res['early_exit_rate_dense']}, K1's trans map "
        f"{rate_k1}, |diff| {diff:.3e} (limit {EXIT_RATE_TOL:g}); the TPU's "
        f"recorded {TPU_DENSE_RATE} (BENCH_r05.json, bfloat16-pass matmuls; "
        "not held)")
    if not diff <= EXIT_RATE_TOL:
        fail(f"dense exit rate: the general sweep's and K1's differ by "
             f"{diff:.3e}")
    log(f"[{gpu_line}] bench_torch.py: {res['value']:.6g} rays/s fwd+bwd "
        f"(vs_baseline {res['vs_baseline']:.4f}), "
        f"{res['ms_per_frame_fwd_bwd']:.3f} ms a step (quartiles "
        f"{res['ms_per_frame_fwd_bwd_quartiles']}, host clock "
        f"{res['host_ms_per_frame_fwd_bwd']:.3f}); general sweep "
        f"{res['ms_per_frame_general']:.3f} ms "
        f"({res['kernels_vs_general']:.4g}x); bfloat16 {res['ms_per_frame_bf16']:.3f} ms (speedup "
        f"{res['bf16_speedup']:.4f}); peak {res['peak_memory_gib']:.3f} GiB; "
        f"bench {res['bench_total_s']:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s")
    return res


# Step 24: the JAX repository's workload tools (tools/ there) as the
# port's runners (volumetricrenderer_tpu_torch/tools/), each main() in this
# process at the JAX tool's full size, on the libraries step 2 built.
# trace_flagship's and profile_parts's (V, W, H, K, I) and
# scaling_rehearsal's (V, IMG, STEPS), as the JAX tools name them
TOOL_SIZE_VARS = ("V", "W", "H", "K", "I", "IMG", "STEPS")
TOOL_SIZE_PREFIXES = ("VOLT_F_", "VOLT_A_", "VOLT_S_", "VOLT_SL_", "VOLT_W_",
                      "VOLT_TRACE_", "VOLT_SH_", "VOLT_SR_", "VOLT_PP_")
TOOL_KEYS = ("device", "power_limit_w", "timed_runs", "launches",
             "general_sweep_calls")
TOOL_LINE_KEYS = {
    "fit_config3": ("loss_first", "loss_last", "loss_drop_x",
                    "losses_every_5", "losses", "skipped_steps", "fit_s",
                    "ms_per_step", "host_ms_per_step", "setup_s"),
    "anim_config4": ("frames", "fps_wall", "ms_per_frame_wall",
                     "ms_per_frame", "mrays_per_s", "plan_s", "setup_s",
                     "warmup_runs"),
    "scale512": ("by_slices", "base_shape", "ms_per_frame_fwd",
                 "ms_per_frame_fwd_bwd", "mrays_per_s_fwd_bwd",
                 "peak_memory_gib", "warmup_runs"),
    "serve_local": ("states", "iters", "init_s", "plan_build_s",
                    "ms_per_frame_device", "fps_device_paced",
                    "ms_per_round_all", "warmup_runs"),
    "measure_warp": ("base_shape", "moveaxis_only", "ms_fwd", "ms_fwd_bwd",
                     "splat_ms_all", "splat_ms_footprint", "pixels",
                     "footprint_pixels"),
    "trace_flagship": ("wall_ms_per_step", "busy_ms_per_step", "idle_share",
                       "top_ops", "warmup_runs"),
    "multichip": ("n_devices", "mesh", "loss", "ok", "launches_per_rank",
                  "total_s"),
    "sharded_step": ("ms_per_frame", "host_ms_per_frame",
                     "launches_per_rank", "base_fwd_sharded_vs_unsharded",
                     "full_fwd_sharded_vs_unsharded",
                     "full_fwdbwd_sharded_vs_unsharded", "fwd_max_abs_diff",
                     "train_step_losses", "train_loss_ratio",
                     "train_6steps_s", "launches_per_variant",
                     "launches_train", "sharded_512_128slices_fwdbwd_ms",
                     "sharded_512_first_call_s", "sharded_512_total_s",
                     "launches_512", "ranks", "warmup_runs", "total_s"),
    "scaling_rehearsal": ("volume", "image", "base_shape", "steps_timed",
                          "shapes", "launches_per_rank", "total_s"),
    "profile_parts": ("ms_per_frame", "host_ms_per_frame",
                      "launches_per_stage", "base_shape", "slices",
                      "warmup_runs", "total_s"),
}
# FIT_r5.json: the JAX package's config-3 fit on a TPU v5e. Its first loss
# is logged beside the port's, not held (the two bake the same scene; the
# TPU's matmuls ran at bfloat16-pass precision).
TPU_FIT_LOSS_FIRST = 0.007647148799151182
FIT_LOSS_DROP_MIN = 100.0  # over the 40 steps; FIT_r5.json recorded 943.9


class LightSpy:
    """Counts, for the time of a `with` block, sweep_fwd's launches that
    were given a light stack (K1's light branch)."""

    def __enter__(self):
        self.launch, self.lit = sweep_fwd.launch_kernel, 0

        def spy(*a, **kw):
            light = kw.get("light", a[9] if len(a) > 9 else None)
            self.lit += light is not None
            return self.launch(*a, **kw)
        sweep_fwd.launch_kernel = spy
        return self

    def __exit__(self, *exc):
        sweep_fwd.launch_kernel = self.launch


def run_tool(name, gpu_line, argv=(), env=None, general=0):
    """main(argv) of one runner in this process, counted from 0, with every
    runner's size variables unset (the JAX tools' full sizes) but `env`:
    its progress (stderr) relayed to the log, its last stdout line parsed
    and held to its keys, the card, and `general` general-sweep calls
    (none but in profile_parts). Returns (line, launches (fwd, bwd,
    ref_fwd, ref_bwd) of the whole run in this process: a sharded runner's
    ranks are processes of their own, which count their own launches and
    report them in the line)."""
    import contextlib
    import importlib
    import io
    mod = importlib.import_module(f"volumetricrenderer_tpu_torch.tools.{name}")
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k in TOOL_SIZE_VARS or k.startswith(TOOL_SIZE_PREFIXES)}
    os.environ.update(env or {})
    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    calls0 = ops_sweep.general_calls
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mod.main(list(argv))
    finally:
        for k in env or {}:
            del os.environ[k]
        os.environ.update(saved)
        for line in err.getvalue().strip().splitlines():
            log(f"  {name}: {line}")
    launches = path_counts(f"tools: {name}")
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        fail(f"tools/{name}: exit code {rc}, {len(lines)} stdout lines")
    res = json.loads(lines[-1])
    missing = [k for k in TOOL_KEYS + TOOL_LINE_KEYS[name] if k not in res]
    if missing:
        fail(f"tools/{name}: the line lacks {missing}")
    if res["device"] != torch.cuda.get_device_name(0):
        fail(f"tools/{name} ran on {res['device']}")
    calls = ops_sweep.general_calls - calls0
    if res["general_sweep_calls"] != general or calls != general:
        fail(f"tools/{name}: {calls} general sweeps "
             f"({res['general_sweep_calls']} in its line), {general} "
             "expected")
    log(f"[{gpu_line}] tools/{name} ({time.perf_counter() - t0:.1f} s, "
        f"launches {launches}): {json.dumps(res)}")
    return res, launches


def expect_launches(name, got, want):
    if tuple(got) != tuple(want):
        fail(f"tools/{name} launched (fwd, bwd, ref_fwd, ref_bwd) {got}, "
             f"expected {want}")


def line_launches(fwd=0, bwd=0):
    """A line's "launches" field of K1 and K2 launches."""
    return {"sweep_fwd": fwd, "sweep_bwd": bwd, "sweep_ref_fwd": 0,
            "sweep_ref_bwd": 0}


def tools_phase(gpu_line):
    """Step 24: the six runners at full width, each counted from 0 and
    held to the launches its workload makes. Returns the launches of each
    run."""
    t_phase = time.perf_counter()
    paths = []
    res, n = run_tool("fit_config3", gpu_line)
    steps = res["steps"]
    expect_launches("fit_config3", n, (1 + steps, steps, 0, 0))
    if res["launches"] != line_launches(steps, steps):
        fail(f"tools/fit_config3: launches in the fit {res['launches']}")
    if (res["volume"], res["image"], steps) != (FIT_SIZE, FIT_IMAGE, 40):
        fail(f"tools/fit_config3 ran {res['volume']}^3 at {res['image']}^2 "
             f"for {steps} steps")
    if res["skipped_steps"] or not all(map(math.isfinite, res["losses"])) \
            or not res["loss_drop_x"] >= FIT_LOSS_DROP_MIN:
        fail(f"tools/fit_config3: the loss fell {res['loss_drop_x']:.4g}x "
             f"(at least {FIT_LOSS_DROP_MIN:g} asked), skipped "
             f"{res['skipped_steps']}")
    log(f"[{gpu_line}] config 3 fit, {steps} steps: loss "
        f"{res['loss_first']:.7g} "
        f"-> {res['loss_last']:.7g} ({res['loss_drop_x']:.5g}x), "
        f"{res['ms_per_step']:.3f} ms a step; the TPU's first loss "
        f"{TPU_FIT_LOSS_FIRST:.7g} (FIT_r5.json; not held)")
    paths.append(n)

    with LightSpy() as spy:
        res, n = run_tool("anim_config4", gpu_line)
    frames, warm = res["frames"], res["warmup_runs"]
    expect_launches("anim_config4", n, (frames + warm, 0, 0, 0))
    if spy.lit != frames + warm or res["launches"] != line_launches(frames):
        fail(f"tools/anim_config4: {spy.lit} K1 launches with light, line "
             f"{res['launches']}, for {frames} frames and {warm} warm-ups")
    paths.append(n)

    res, n = run_tool("scale512", gpu_line)
    runs, warm, rows = res["timed_runs"], res["warmup_runs"], res["by_slices"]
    expect_launches("scale512", n, (2 * len(rows) * (runs + warm),
                                    len(rows) * (runs + warm), 0, 0))
    for S, row in rows.items():
        if row["launches_fwd"] != line_launches(runs) \
                or row["launches_fwd_bwd"] != line_launches(runs, runs):
            fail(f"tools/scale512 at {S} slices: launches "
                 f"{row['launches_fwd']}, {row['launches_fwd_bwd']}")
    if sorted(map(int, rows)) != [128, 256, 512] or res["volume"] != 512:
        fail(f"tools/scale512 ran {res['volume']}^3 at slices {list(rows)}")
    paths.append(n)

    res, n = run_tool("serve_local", gpu_line)
    k, iters = res["states"], res["iters"]
    expect_launches("serve_local", n, (k * (iters + res["warmup_runs"]), 0,
                                       0, 0))
    if res["launches"] != line_launches(k * iters):
        fail(f"tools/serve_local: line launches {res['launches']}")
    paths.append(n)

    res, n = run_tool("measure_warp", gpu_line)
    expect_launches("measure_warp", n, (0, 0, 0, 0))
    paths.append(n)

    res, n = run_tool("trace_flagship", gpu_line)
    steps = res["timed_runs"] + res["warmup_runs"]
    expect_launches("trace_flagship", n, (steps, steps, 0, 0))
    names = [op["name"] for op in res["top_ops"]]
    for kernel in ("sweep_fwd_kernel", "sweep_bwd_kernel"):
        if not any(kernel in op for op in names):
            fail(f"tools/trace_flagship: no {kernel} among the top ops")
    paths.append(n)
    log(f"tools phase (six runners): {time.perf_counter() - t_phase:.1f} s")
    return paths


# Step 25: the sharded path's entry points (__graft_entry__.dryrun_multichip,
# tools/sharded_tpu.py and tools/scaling_rehearsal.py there) and the stage
# profiler (tools/profile_parts.py) as the port's runners, at full width on
# every card present: one rank per card, spawned by tools.spawn_ranks. The
# ranks' launches are their own counters (fresh processes, from 0),
# reported in each line; this process must launch none of them.
NO_LAUNCH = (0, 0, 0, 0)


def kernel_tuple(d):
    """A line's launches dict as (fwd, bwd, ref_fwd, ref_bwd)."""
    return tuple(d[name] for name in KERNELS)


def mesh_shapes(n):
    """Every (data, slab) with data * slab = n: the JAX rehearsal's shapes
    at n = 8."""
    return [(d, n // d) for d in range(n, 0, -1) if n % d == 0]


def expect_tuple(name, what, got, want):
    if tuple(got) != tuple(want):
        fail(f"tools/{name}: {what} launched (fwd, bwd, ref_fwd, ref_bwd) "
             f"{tuple(got)}, expected {tuple(want)}")


def rank_launches(name, res, n, want):
    """Each of the n ranks' launches over its whole run, as the line
    reports them (launches_per_rank; rank 0's also as launches), held to
    `want`. Returns them as tuples."""
    got = [kernel_tuple(x) for x in res["launches_per_rank"]]
    if len(got) != n or kernel_tuple(res["launches"]) != got[0]:
        fail(f"tools/{name}: launches per rank {got}, rank 0's line "
             f"{res['launches']}, for {n} ranks")
    for r, t in enumerate(got):
        expect_tuple(name, f"rank {r}", t, want)
    return got


def falls(name, losses):
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"tools/{name}: the loss did not fall: {losses}")


def sharded_runners_phase(gpu_line):
    """Step 25: multichip, sharded_step and scaling_rehearsal at ranks =
    the cards present; each line parsed and held to its keys, the K1 and
    K2 launches its runner counts, the 1x1 frame equal to the unsharded
    one bit for bit, every train run's loss falling. Returns the ranks'
    launch tuples (their own counters)."""
    import torch.distributed as dist
    from volumetricrenderer_tpu_torch.tools import multichip, sharded_step
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    if dist.is_initialized():
        fail("a process group is still running before the runners")
    ranks = []
    # the ranks build their volumes on the cards this process holds too
    torch.cuda.empty_cache()

    res, here = run_tool("multichip", gpu_line)
    expect_tuple("multichip", "this process", here, NO_LAUNCH)
    if (res["n_devices"], res["mesh"], res["ok"]) != \
            (n, list(multichip.mesh_shape(n)), True) \
            or not math.isfinite(res["loss"]):
        fail(f"tools/multichip: {res}")
    # each rank: the target frame (K1) and the step (K1, K2), shadowed
    ranks += rank_launches("multichip", res, n, (2, 1, 0, 0))
    log(f"[{gpu_line}] multichip, {n} ranks, mesh {res['mesh']}: loss "
        f"{res['loss']:.7g}, launches per rank "
        f"{[kernel_tuple(x) for x in res['launches_per_rank']]}")

    torch.cuda.empty_cache()
    res, here = run_tool("sharded_step", gpu_line, ["--ranks", str(n)])
    expect_tuple("sharded_step", "this process", here, NO_LAUNCH)
    it, warm = res["timed_runs"], res["warmup_runs"]
    if res["ranks"] != n or (res["volume"], res["width"], res["height"]) \
            != (VOLUME, WIDTH, HEIGHT):
        fail(f"tools/sharded_step ran {res['ranks']} ranks at "
             f"{res['volume']}^3, {res['width']}x{res['height']}")
    if n == 1 and res["fwd_max_abs_diff"] != 0.0:
        fail("tools/sharded_step: the 1x1 sharded frame is not the unsharded "
             f"one bit for bit: max abs diff {res['fwd_max_abs_diff']}")
    if not res["fwd_max_abs_diff"] < SHARD_MAP_TOL:
        fail(f"tools/sharded_step: fwd_max_abs_diff {res['fwd_max_abs_diff']}")
    for variant, got in res["launches_per_variant"].items():
        want = (it, it if "fwdbwd" in variant else 0, 0, 0)
        expect_tuple("sharded_step", variant, kernel_tuple(got), want)
    steps = len(res["train_step_losses"])
    falls("sharded_step", res["train_step_losses"])
    expect_tuple("sharded_step", "the train steps",
                 kernel_tuple(res["launches_train"]), (steps, steps, 0, 0))
    n512 = 1 + max(it - 1, 2)
    expect_tuple("sharded_step", "the 512 phase",
                 kernel_tuple(res["launches_512"]), (n512, n512, 0, 0))
    total = (6 * (warm + it) + 2 + steps + n512,
             2 * (warm + it) + steps + n512, 0, 0)
    ranks += rank_launches("sharded_step", res, n, total)
    log(f"[{gpu_line}] sharded_step, {n} ranks: ms per frame "
        f"{res['ms_per_frame']}; sharded/unsharded base "
        f"{res['base_fwd_sharded_vs_unsharded']:.4f}, full fwd "
        f"{res['full_fwd_sharded_vs_unsharded']:.4f}, fwd+bwd "
        f"{res['full_fwdbwd_sharded_vs_unsharded']:.4f}; fwd_max_abs_diff "
        f"{res['fwd_max_abs_diff']}; train losses "
        f"{res['train_step_losses']}; 512^3 at 128 slices fwd+bwd "
        f"{res['sharded_512_128slices_fwdbwd_ms']:.3f} ms")

    torch.cuda.empty_cache()
    shapes = mesh_shapes(n)
    res, here = run_tool("scaling_rehearsal", gpu_line, env={
        "VOLT_SR_SHAPES": ",".join(f"{d}x{s_}" for d, s_ in shapes)})
    expect_tuple("scaling_rehearsal", "this process", here, NO_LAUNCH)
    if [(r["mesh"]["data"], r["mesh"]["slab"]) for r in res["shapes"]] \
            != shapes or (res["volume"], res["image"]) != (128, 512):
        fail(f"tools/scaling_rehearsal ran {res['volume']}^3 at "
             f"{res['image']}^2 on {[r['mesh'] for r in res['shapes']]}")
    k = res["steps_timed"] + 1  # the first call and the timed ones
    for row in res["shapes"]:
        falls("scaling_rehearsal", row["losses"])
        expect_tuple("scaling_rehearsal", f"mesh {row['mesh']}",
                     kernel_tuple(row["launches"]), (2 * k, k, 0, 0))
    # each rank (every shape fills the one world of n ranks): its unsharded
    # target frame and its shapes
    ranks += rank_launches("scaling_rehearsal", res, n,
                           (1 + 2 * k * len(shapes), k * len(shapes), 0, 0))
    log(f"[{gpu_line}] scaling_rehearsal, shapes {shapes}: " + "; ".join(
        f"{r['mesh']['data']}x{r['mesh']['slab']} {r['ms_per_step']:.3f} ms a "
        f"step, frame {r['fwd_render_ms']:.3f} ms, first step "
        f"{r['first_step_s']:.2f} s, final loss {r['final_loss']:.7g}"
        for r in res["shapes"]))
    log(f"sharded runners phase: {time.perf_counter() - t_phase:.1f} s")
    return ranks


def profile_parts_phase(gpu_line):
    """Step 25, last: profile_parts in this process at the flagship, each
    stage's K1 and K2 launches and the general sweep's calls held to what
    it counts. Returns its launch tuple."""
    t_phase = time.perf_counter()
    runs = 2 * 2  # K * I, the JAX tool's frames
    res, here = run_tool("profile_parts", gpu_line,
                         general=runs + tools.WARMUP)
    calls = runs + res["warmup_runs"]
    if res["timed_runs"] != runs or (res["volume"], res["width"],
                                     res["height"]) != (VOLUME, WIDTH,
                                                        HEIGHT):
        fail(f"tools/profile_parts: {res['timed_runs']} timed runs at "
             f"{res['volume']}^3, {res['width']}x{res['height']}")
    for stage, got in res["launches_per_stage"].items():
        fwd = stage in ("base_fwd", "full_fwd", "base_fwdbwd", "full_fwdbwd")
        want = (runs if fwd else 0,
                runs if stage in ("base_fwdbwd", "full_fwdbwd") else 0, 0, 0)
        expect_tuple("profile_parts", stage, kernel_tuple(got), want)
    # the base maps the warp stages read (K1), then the stages' calls
    expect_tuple("profile_parts", "the run", here,
                 (1 + 4 * calls, 2 * calls, 0, 0))
    log(f"[{gpu_line}] profile_parts at {VOLUME}^3, {WIDTH}x{HEIGHT}: ms "
        f"per frame {res['ms_per_frame']} ({time.perf_counter() - t_phase:.1f}"
        " s)")
    return here


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None,
                        help="directory for the PNGs and the profiles")
    args = parser.parse_args(argv)

    t_start = time.perf_counter()
    # 1. Device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "GPU")
    out_dir = args.out or os.path.join(
        os.path.dirname(os.path.abspath(sweep_fwd.__file__)), os.pardir,
        "_build")
    os.makedirs(out_dir, exist_ok=True)
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

    # 2. Build.
    regs = {}
    builds = build_all()
    builds["light_sweep"] = light_sweep.build_kernel()
    for name, info in builds.items():
        log(f"build {name}: {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].strip().splitlines():
            log(f"  nvcc: {line}")
        regs[name] = ptxas_report(info["log"])

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

    # 4b. The tiled schedule's stress cases (TILED_STRESS).
    tiled = tiled_stress_checks(dev)
    errs += tiled["sweep_fwd"]
    bwd_errs += tiled["sweep_bwd"]

    # 5. bench.py's gradient check, through the kernels (the port's bench
    # runs the same function).
    ok, err, scale = bench.validate_gradients(dev)
    log(f"grad check: allclose={ok} max_abs_err={err:.3e} scale={scale:.3e}")
    if not ok:
        fail("bench gradient check: the kernels' grid gradient disagrees "
             "with the per-ray oracle's")

    # 6. Serving: the flagship forward, a few requests through
    # render_image.
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
    serve_launches = path_counts("flagship serving")
    log(f"serving path: {len(frames)} frames, launches (fwd, bwd, ref_fwd, "
        f"ref_bwd) {serve_launches}")
    if serve_launches != (len(frames), 0, 0, 0):
        fail(f"serving path launched {serve_launches}, expected "
             f"({len(frames)}, 0, 0, 0)")

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
    reset_counts()
    g = grid.clone().requires_grad_()
    with BackwardSpy(sweep_bwd) as spy:
        img = render_image(g, cam, cfg, medium, plan=plan)
        loss = (img[..., :3] ** 2).sum()
        loss.backward()
        torch.cuda.synchronize()
    step_launches = path_counts("flagship forward+backward step")
    if step_launches != (1, 1, 0, 0) or len(spy.seen) != 1:
        fail(f"flagship forward+backward launched {step_launches}, "
             f"expected (1, 1, 0, 0)")
    bwd_args, _, dG = spy.seen[0]
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
    log(f"flagship fwd+bwd: loss {loss.item():.6e}, launches "
        f"{step_launches}, dG max abs err {e_flag:.3e} at max|dG| "
        f"{scale_flag:.3e}, grad nonzero share "
        f"{float((g.grad != 0).float().mean()):.4f}")

    t0 = time.perf_counter()
    target3, cam3, _, _ = fit_config3.workload(FIT_SIZE, FIT_IMAGE, dev)
    log(f"config 3 target: baked {FIT_SIZE}^3 cloud+smoke, rendered "
        f"{FIT_IMAGE}x{FIT_IMAGE} in {time.perf_counter() - t0:.2f} s")
    before = counts()
    clock = StepClock(dev)
    t0 = time.perf_counter()
    res = fit_config3.fit(target3, cam3, cfg, medium, FIT_SIZE, FIT_STEPS,
                          metrics=clock)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = tuple(a - b for a, b in zip(counts(), before))
    train_launches = path_counts("config 3 fit")
    log(f"config 3 fit: losses {[f'{x:.6e}' for x in res.losses]}, "
        f"skipped {res.skipped_steps}, launches {fit_launches}, "
        f"{fit_s:.2f} s with the plan build")
    if fit_launches != (FIT_STEPS, FIT_STEPS, 0, 0):
        fail(f"fit launched {fit_launches}, expected "
             f"({FIT_STEPS}, {FIT_STEPS}, 0, 0)")
    if res.skipped_steps or not all(math.isfinite(x) for x in res.losses) \
            or not res.losses[-1] < res.losses[0]:
        fail(f"config 3 fit did not descend: losses {res.losses}, skipped "
             f"{res.skipped_steps}")
    fit_step_ms, fit_host_ms, fit_span = clock.per_step_ms()
    log(f"training path: launches (fwd, bwd, ref_fwd, ref_bwd) "
        f"{train_launches}")

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
    measure_warp.warp_timings(maps, plan, cfg, medium, log=log)
    log(f"  render_image              {render_ms:.3f} ms = "
        f"{rays / (render_ms * 1e-3):.4g} forward rays/s (plan excluded)")
    log(f"  forward+backward step     {fwdbwd_ms:.3f} ms = "
        f"{rays / (fwdbwd_ms * 1e-3):.4g} fwd+bwd rays/s (plan excluded)")
    log(f"  plan build (host)         {plan_s * 1e3:.1f} ms")
    log(f"[{gpu_line}] config 3 fit {FIT_SIZE}^3 at {FIT_IMAGE}x"
        f"{FIT_IMAGE}: {fit_step_ms:.3f} ms per step (CUDA events between "
        f"fit_grid's metric writes, over {fit_span} steps; host clock "
        f"{fit_host_ms:.3f}), loss {res.losses[0]:.6e} -> "
        f"{res.losses[-1]:.6e}")
    profile_fwdbwd(fwdbwd, out_dir)
    samples, lines = inbox_samples(plan)
    min_t = float(maps[1].min())
    log(f"  {samples} of {plan.slice_z.shape[0] * maps[0].numel()} samples "
        f"in the box and in front, on {lines} rows and columns; min T "
        f"{min_t:.4f} against the early-stop threshold "
        f"{cfg.early_stop_transmittance}"
        + ("" if min_t > cfg.early_stop_transmittance else
           " (some rays ended early: the in-box count is an upper bound)"))
    # Emission reads ct_trans, ct_wsum, trans and wsum (bwd_args[7:11]) and
    # writes a dG of the stack's size.
    work = {"sweep_fwd": (samples, lines, (*fwd_args, *maps)),
            "sweep_bwd": (samples, lines, (*bwd_args[:6], *bwd_args[7:11],
                                           bwd_args[0]))}

    # 9. The 4-channel reference-combine kernels at small shapes.
    ref_errs, ref_bwd_errs = ref_small_checks(dev)

    # 9b. The tiled schedule of K4 and K5 under stress (REF_TILED_STRESS).
    ref_tiled = ref_tiled_stress_checks(dev)
    ref_errs += ref_tiled["sweep_ref_fwd"]
    ref_bwd_errs += ref_tiled["sweep_ref_bwd"]

    # 10. The reference preset at full width: serving and training.
    e_f, e_b, ref_serve, ref_train, grid4, cam4, plan4 = ref_full_width(
        dev, out_dir)
    ref_errs += e_f
    ref_bwd_errs += e_b

    # 11. Timing of the 4-channel path: at the preset, then (timing only)
    # at the flagship's size.
    ref_t = ref_timings(grid4, cam4, plan4, dev, gpu_line)
    profile_fwdbwd(ref_t["fwdbwd_fn"], out_dir,
                   "chip_smoke_profile_reference.txt")
    work["sweep_ref_fwd"] = (ref_t["samples"], ref_t["lines"],
                             ref_t["fwd_tensors"])
    work["sweep_ref_bwd"] = (ref_t["samples"], ref_t["lines"],
                             ref_t["bwd_tensors"])
    t0 = time.perf_counter()
    big4 = build_volume(VolumeConfig(size=VOLUME), device=dev)
    torch.cuda.synchronize()
    log(f"build_volume(VolumeConfig(size={VOLUME})): "
        f"{time.perf_counter() - t0:.2f} s")
    ref_timings(big4, cams[0][1],
                plan_for(cams[0][1], big4.shape, cfg, device=dev), dev,
                gpu_line, plain_runs=3)

    # 12. The light branch at small shapes, and the gradient checks with
    # shadows.
    light_errs = [light_small_checks(dev)]

    # 13. Config 4 at full width: shadowed serving and training.
    e4, c4_serve, c4_train, cam_c4, plan_c4 = config4_full_width(
        grid, dev, out_dir)
    light_errs.append(e4)

    # 14. The reference medium with shadows at the preset's width.
    e4r, ref_sh_serve, ref_sh_train = ref_shadow_full_width(grid4, cam4,
                                                            plan4, dev)
    light_errs.append(e4r)

    # 15. Timing of the shadowed paths.
    light_t = light_timings(grid, cam_c4, plan_c4, grid4, cam4, plan4, dev,
                            gpu_line, out_dir)

    # 17. The bfloat16 stream mode at small shapes: the rounding probe,
    # kernel against plain version, the gradient check in the mode.
    low_errs = [bf16_small_checks(dev)]

    # 18. The main paths in the mode at full width, each counted from 0.
    e_low, low_paths = bf16_full_width(dev, grid, frames, cams, grid4, cam4,
                                       plan4)
    low_errs.append(e_low)

    # 19. Timing of the mode beside float32 on the same plans.
    low_t = bf16_timings(grid, cam, plan, cam_c4, plan_c4, grid4, cam4,
                         plan4, dev, gpu_line)

    # 20. The preset front end on the card.
    preset_paths, e_preset = preset_front_end(dev, out_dir)
    low_errs.append(e_preset)

    # 21. The viewer front end: serve and animate.
    front_paths, e_front = front_end(dev, out_dir, gpu_line)
    low_errs.append({"sweep_fwd": e_front, "sweep_bwd": [],
                     "sweep_ref_fwd": [], "sweep_ref_bwd": []})

    # 22. The slab-sharded sweep (parallel/): config 5.
    shard_paths, e_shard, shard_t = sharded_phase(dev, out_dir, gpu_line)
    low_errs.append(e_shard)

    # 23. The port's bench, bench_torch.py, in a process of its own.
    bench_phase(grid, frames[0][1], cfg, medium, out_dir, gpu_line)

    # 24. The runners of volumetricrenderer_tpu_torch/tools/ at full width.
    tool_paths = tools_phase(gpu_line)

    # 25. The sharded path's runners over a rank per card, and the stage
    # profiler.
    rank_paths = sharded_runners_phase(gpu_line)
    parts_paths = [profile_parts_phase(gpu_line)]

    # 26. Results. No single PyTorch call marches a carried, gated slice
    # sweep (grid_sample does one slice's taps only), so library_ms is null.
    times = {"sweep_fwd": (kernel_ms, plain_ms),
             "sweep_bwd": (bwd_ms, bwd_plain_ms),
             "sweep_ref_fwd": (ref_t["fwd"], ref_t["fwd_plain"]),
             "sweep_ref_bwd": (ref_t["bwd"], ref_t["bwd_plain"])}
    kernel_errs = {"sweep_fwd": errs, "sweep_bwd": bwd_errs,
                   "sweep_ref_fwd": ref_errs, "sweep_ref_bwd": ref_bwd_errs}
    main_paths = (serve_launches, train_launches, ref_serve, ref_train)
    light_paths = (c4_serve, c4_train, ref_sh_serve, ref_sh_train)
    results = []
    for k, (name, (_, source, line)) in enumerate(KERNELS.items()):
        launches_light = sum(path[k] for path in light_paths)
        launches_low = sum(path[k] for path in low_paths)
        launches_preset = sum(path[k] for path in preset_paths)
        launches_front = sum(path[k] for path in front_paths)
        launches_sharded = sum(path[k] for path in shard_paths)
        launches_tools = sum(path[k] for path in tool_paths)
        launches_ranks = sum(path[k] for path in rank_paths)
        launches_parts = sum(path[k] for path in parts_paths)
        launches_f32 = sum(path[k] for path in main_paths) + launches_light
        launches = launches_f32 + launches_low + launches_preset \
            + launches_front + launches_sharded + launches_tools \
            + launches_ranks + launches_parts
        if launches_f32 - launches_light < 1 or launches_light < 1 \
                or launches_low < 1 or launches_sharded < 1:
            fail(f"{name}: no launch on a main path ({launches} in all, "
                 f"{launches_light} with a light volume, {launches_low} in "
                 f"bfloat16, {launches_sharded} on the sharded paths)")
        bound_ms, bound_by, flops, nbytes = bound(name, *work[name])
        ms, plain = times[name]
        log(f"[{gpu_line}] {name}: {ms:.3f} ms against a bound of "
            f"{bound_ms:.4f} ms ({bound_by}: {flops:.4g} float operations "
            f"at 67 TFLOP/s, {nbytes:.4g} bytes at 3.35 TB/s), {launches} "
            "launches on the main paths")
        ms_l, plain_l, *work_l = light_t[name]
        bound_l, by_l, flops, nbytes = bound(name + "+light", *work_l)
        log(f"[{gpu_line}] {name} with a light volume: {ms_l:.3f} ms "
            f"against a bound of {bound_l:.4f} ms ({by_l}: {flops:.4g} "
            f"float operations, {nbytes:.4g} bytes), {launches_light} of "
            "those launches")
        lt = low_t[name]
        bound_low, by_low, flops, nbytes = bound(name, *lt["work"])
        bound_low_l, by_low_l, flops_l, nbytes_l = bound(name + "+light",
                                                         *lt["work_light"])
        log(f"[{gpu_line}] {name} in bfloat16: {lt['ms']:.3f} ms (float32 "
            f"on the same plan {lt['f32']:.3f} ms) against a bound of "
            f"{bound_low:.4f} ms ({by_low}: {flops:.4g} float operations, "
            f"{nbytes:.4g} bytes); with a light volume {lt['ms_light']:.3f} "
            f"ms (float32 {lt['f32_light']:.3f} ms) against "
            f"{bound_low_l:.4f} ms ({by_low_l}: {flops_l:.4g} float "
            f"operations, {nbytes_l:.4g} bytes); {launches_low} launches on "
            f"the bfloat16 main paths, {launches_preset} on the presets', "
            f"{launches_front} on serve's and animate's, {launches_sharded} "
            f"on the sharded paths (parallel/), {launches_tools} in the "
            f"runners (tools/), {launches_ranks} in the sharded runners' "
            f"ranks, {launches_parts} in profile_parts")
        log(f"[{gpu_line}] {name} share of its bound: float32 "
            f"{bound_ms / ms:.4f}, with light {bound_l / ms_l:.4f}, bfloat16 "
            f"{bound_low / lt['ms']:.4f}, bfloat16 with light "
            f"{bound_low_l / lt['ms_light']:.4f}")
        tiles = TILES[name]
        if tiles[0] < 1:
            fail(f"{name}: no tile-slice computed on the main paths")
        log(f"[{gpu_line}] {name} on the main paths: {tiles[0]} "
            f"tile-slices, {tiles[1]} through global memory (share "
            f"{tiles[1] / tiles[0]:.4g})")
        if name.startswith("sweep_ref") and tiles[1]:
            fail(f"{name}: {tiles[1]} tile-slices of the main paths read "
                 "through global memory: the stage sized from the plan did "
                 "not hold their windows")
        n_regs, spill = regs[name]
        log(f"[{gpu_line}] {name} registers per instantiation (ptxas) "
            f"{n_regs}, most spill-store bytes {spill}")
        kernel_errs[name] += [e for errs_ in light_errs + low_errs
                              for e in errs_[name]]
        results.append({
            "name": name,
            "route": "cuda",
            "source": f"volumetricrenderer_tpu_torch/kernels/csrc/{source}",
            "replaces":
                f"volumetricrenderer_tpu/kernels/sweep_pallas.py:{line}",
            "launches": launches,
            "max_abs_err": max(kernel_errs[name]),
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "launches_light": launches_light,
            "ms_light": ms_l,
            "plain_ms_light": plain_l,
            "bound_ms_light": bound_l,
            "bound_by_light": by_l,
            "launches_bf16": launches_low,
            "launches_front_end": launches_front,
            "launches_sharded": launches_sharded,
            "launches_tools": launches_tools,
            "launches_runner_ranks": launches_ranks,
            "launches_profile_parts": launches_parts,
            "ms_bf16": lt["ms"],
            "ms_bf16_light": lt["ms_light"],
            "plain_ms_bf16": lt["plain_ms"],
            "bound_ms_bf16": bound_low,
            "bound_by_bf16": by_low,
            "bound_ms_bf16_light": bound_low_l,
            "bound_share": bound_ms / ms,
            "bound_share_light": bound_l / ms_l,
            "registers": n_regs,
            "spill_bytes": spill,
            "tile_slices": tiles[0],
            "tile_slices_global": tiles[1],
        })
    log(f"[{gpu_line}] config5 (parallel/): render_image "
        f"{shard_t['render_ms']:.3f} ms, 1x1 sharded frame "
        f"{shard_t['sharded_ms']:.3f} ms, sharded train step "
        f"{shard_t['step_ms']:.3f} ms, K1 {shard_t['k1_ms']:.3f} ms, K2 "
        f"{shard_t['k2_ms']:.3f} ms")
    lt = light_t["light_sweep"]
    log(f"[{gpu_line}] light_sweep: {lt['ms']:.3f} ms against a bound of "
        f"{lt['bound_ms']:.4f} ms (share {lt['bound_ms'] / lt['ms']:.4f}), "
        f"adjoint {lt['adjoint_ms']:.3f} ms against "
        f"{lt['bound_ms_adjoint']:.4f} ms (share "
        f"{lt['bound_ms_adjoint'] / lt['adjoint_ms']:.4f}); launches on the "
        f"main paths {LIGHT_SWEEP}")
    if min(LIGHT_SWEEP.values()) < 1:
        fail(f"light_sweep: launches {LIGHT_SWEEP}: no forward or no "
             "adjoint on the main paths")
    n_regs, spill = regs["light_sweep"]
    results.append({
        "name": "light_sweep",
        "route": "cuda",
        "source": "volumetricrenderer_tpu_torch/kernels/csrc/light_sweep.cu",
        "replaces": None,
        "launches": sum(LIGHT_SWEEP.values()),
        "launches_adjoint": LIGHT_SWEEP["adjoint"],
        "max_abs_err": lt["max_abs_err"],
        "ms": lt["ms"],
        "adjoint_ms": lt["adjoint_ms"],
        "plain_ms": lt["plain_ms"],
        "bound_ms": lt["bound_ms"],
        "bound_ms_adjoint": lt["bound_ms_adjoint"],
        "bound_by": "bytes",
        "library_ms": None,
        "bound_share": lt["bound_ms"] / lt["ms"],
        "bound_share_adjoint": lt["bound_ms_adjoint"] / lt["adjoint_ms"],
        "registers": n_regs,
        "spill_bytes": spill,
    })
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
