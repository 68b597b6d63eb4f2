"""The device-paced serve frame loop (port of tools/serve_local.py): the
serve renderer's frame at config2, 512x512, over a walk of K = 32 distinct
interaction states, back to back, with no fetch, PNG or HTTP: what the
card alone would pace the live loop at. Each frame launches K1 once.

    python -m volumetricrenderer_tpu_torch.tools.serve_local
        [--device cuda|cpu] [--out PATH]

Env: VOLT_SL_SIZE (512: the image's width and height), VOLT_SL_K (32),
VOLT_SL_ITERS (4: timed rounds of the K frames, after one untimed round);
for a smaller run VOLT_SL_VOLUME (the preset's 128).

The walk presses the JAX tool's keys (KEYS, over and over) on an
InteractiveRenderer(PRESETS["config2"]) and keeps each new (azimuth,
elevation, distance) until it has K; their plans are built through the
renderer's plan cache (_plan_cached) in setup, as plan_build_s. The JAX
tool keeps only the states whose plans share one XLA signature, so that
they stack into one scanned executable; that filter is TPU-only and is not
ported: every state walked is kept. A timed frame is the device part of
InteractiveRenderer.dispatch_frame, InteractiveRenderer.present: the
render and the uint8 RGB over the page background, at media time 0.

The JSON line has the JAX artifact's keys (INTERACTIVE_LOCAL_r*.json) but
these TPU ones: null_dispatch_ms, n_signatures_walked, compile_s and
states_per_dispatch (here "states"); dispatch_ms_all becomes
ms_per_round_all (device ms of each timed round of K frames). Added:
volume, host_ms_per_frame, force_dims, power_limit_w, timed_runs,
warmup_runs, launches (the timed rounds) and general_sweep_calls (the
whole run).
"""
from __future__ import annotations

import dataclasses
import itertools
import statistics
import time

from ..config import PRESETS
from ..serve import InteractiveRenderer
from ..utils.clock import sync
from . import Counts, device_of, emit, env_int, log, parse_args, time_calls

__all__ = ["KEYS", "workload", "walk", "frames", "run", "main"]

KEYS = "ddddqqddwwddssddeeddddqqdddddddd"  # the JAX tool's walk
MAX_PASSES = 64  # of KEYS, before a walk that finds too few states fails


def workload(size: int, volume: int, device):
    """InteractiveRenderer of config2 at size x size and volume^3 (its
    volume and the force_dims probe built)."""
    preset = PRESETS["config2"]
    preset = dataclasses.replace(
        preset, volume=dataclasses.replace(preset.volume, size=volume),
        camera=dataclasses.replace(preset.camera, width=size, height=size))
    return InteractiveRenderer(preset, device=device)


def walk(r, k: int):
    """Press KEYS on r, over and over, until k distinct (azimuth,
    elevation, distance) states were visited; returns them in order."""
    states, seen = [], set()
    for key in itertools.islice(itertools.cycle(KEYS),
                                MAX_PASSES * len(KEYS)):
        r.key(key)
        state = (r.azim, r.elev, r.dist)
        lattice = tuple(round(x, 6) for x in state)  # the plan cache's key
        if lattice not in seen:
            seen.add(lattice)
            states.append(state)
            if len(states) == k:
                return states
    raise ValueError(f"the walk visited {len(states)} states, not {k}")


def frames(r, plans):
    """The timed function: the frames at `plans`, back to back (a list of
    (H, W, 3) uint8 tensors on the renderer's device)."""
    return [r.present(plan, 0.0) for plan in plans]


def run(device="cuda") -> dict:
    size = env_int("VOLT_SL_SIZE", 512)
    k = env_int("VOLT_SL_K", 32)
    iters = env_int("VOLT_SL_ITERS", 4)
    volume = env_int("VOLT_SL_VOLUME", PRESETS["config2"].volume.size)
    dev, line_device = device_of(device)
    whole = Counts()
    t0 = time.perf_counter()
    r = workload(size, volume, dev)
    sync(r.grid)
    init_s = time.perf_counter() - t0
    log(f"renderer init {init_s:.2f} s; dims {r.force_dims}")
    t0 = time.perf_counter()
    plans = [r._plan_cached(*state) for state in walk(r, k)]
    sync(plans[-1].warp_rows01)
    plan_build_s = time.perf_counter() - t0
    log(f"built {len(plans)} plans in {plan_build_s:.2f} s")

    dev_ms, host_ms, timed = time_calls(lambda: frames(r, plans), dev,
                                        iters, warmup=1)
    per = statistics.median(dev_ms) / k
    log(f"{k} states x {iters} rounds: {per:.3f} ms a frame (host clock "
        f"{statistics.median(host_ms) / k:.3f}), launches {timed}")
    return {
        "what": "device-paced serve frame loop: the serve renderer's frame "
                "(render + uint8-RGB present, InteractiveRenderer.present) "
                "over a walk of K distinct orbit states back to back, no "
                "fetch, PNG or HTTP",
        "preset": r.preset.name, "volume": volume, "width": size,
        "height": size,
        "states": k, "iters": iters,
        "init_s": init_s,
        "plan_build_s": plan_build_s,
        "ms_per_frame_device": per,
        "fps_device_paced": 1e3 / per,
        "host_ms_per_frame": statistics.median(host_ms) / k,
        "ms_per_round_all": dev_ms,
        "force_dims": list(r.force_dims),
        "note": "per-frame plan/camera varies (one plan per state from the "
                "renderer's plan cache); excludes HTTP/PNG/download, "
                "includes the uint8-RGB present conversion",
        **line_device,
        "timed_runs": iters,
        "warmup_runs": 1,
        "launches": timed,
        "general_sweep_calls": whole.read()["general_sweep_calls"],
    }


def main(argv=None) -> int:
    args = parse_args(__doc__, argv)
    return emit(run(args.device), args.out)


if __name__ == "__main__":
    raise SystemExit(main())
