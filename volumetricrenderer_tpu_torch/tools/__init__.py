"""The JAX repository's workload tools (tools/ at the repository root),
ported as runners of this package, one module each:

    python -m volumetricrenderer_tpu_torch.tools.NAME

    fit_config3     config 3's fit          anim_config4   config 4's orbit
    scale512        config 5's volume       serve_local    serve's frames
    measure_warp    the screen warp         trace_flagship per-op profile

Each takes `--device` ("cuda" by default: without a GPU the command fails
with torch's own error; "cpu" runs the kernels' plain versions) and `--out
PATH` (the only way a runner writes a file), runs at the JAX tool's full
size unless the environment variables its docstring names cut it, logs its
progress on stderr and prints one JSON line last on stdout. Each module
exposes `workload()`, which builds the inputs, the function it times, and
`run(device)`, which returns the line's fields; `main(argv)` parses the
arguments, runs and prints.

The TPU tools' tunnel devices are not ported: the null-dispatch
calibration, the `lax.scan` of many frames in one dispatch and the
`g * (1 + 0 * t)` guard against XLA's hoisting (bench.py's docstring says
why). A timing here is CUDA events around each timed call, the median
after warm-ups, beside the host clock of the same calls
(bench._time_steps). This module holds what the runners share.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

from ..bench import _power_limit_w, _time_steps
from ..kernels import sweep_bwd, sweep_fwd, sweep_ref_bwd, sweep_ref_fwd
from ..ops import sweep as ops_sweep

__all__ = ["RUNNERS", "WARMUP", "log", "env_int", "parse_args", "device_of",
           "launches", "launches_since", "time_calls", "median_ms", "Counts",
           "emit"]

RUNNERS = ("fit_config3", "anim_config4", "scale512", "serve_local",
           "measure_warp", "trace_flagship")
WARMUP = 2  # untimed calls before the timed ones, in every runner
KERNELS = {"sweep_fwd": sweep_fwd, "sweep_bwd": sweep_bwd,
           "sweep_ref_fwd": sweep_ref_fwd, "sweep_ref_bwd": sweep_ref_bwd}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def parse_args(doc: str, argv=None):
    """--device and --out, the two arguments every runner takes."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help='torch device (default "cuda": fails without '
                             'a GPU); "cpu" runs the plain PyTorch versions '
                             "of the kernels")
    parser.add_argument("--out", default=None,
                        help="also write the JSON line to this file (no "
                             "file is written without it)")
    return parser.parse_args(argv)


def device_of(device):
    """(torch.device, the line's "device" and "power_limit_w" fields): the
    card's name and its power limit from nvidia-smi on CUDA; "cpu" and None
    on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        kind, power = torch.cuda.get_device_name(dev), _power_limit_w(dev)
        log(f"device {kind}, power limit {power} W")
        return dev, {"device": kind, "power_limit_w": power}
    return dev, {"device": str(dev), "power_limit_w": None}


def launches() -> dict:
    """Launches of the four sweep kernels so far, by name."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def launches_since(before: dict) -> dict:
    return {name: n - before[name] for name, n in launches().items()}


class Counts:
    """Kernel launches and general-sweep calls from its creation on: the
    fields "launches" and "general_sweep_calls" of a line."""

    def __init__(self):
        self.kernels = launches()
        self.general = ops_sweep.general_calls

    def read(self) -> dict:
        return {"launches": launches_since(self.kernels),
                "general_sweep_calls": ops_sweep.general_calls
                - self.general}


def time_calls(fn, device, runs: int, warmup: int = WARMUP):
    """(device ms, host ms, launches): the times of each of `runs` timed
    calls of fn() after `warmup` untimed ones (bench._time_steps: CUDA
    events around each call on CUDA, each call synchronized; the host clock
    alone on the CPU), and the kernel launches of the timed calls."""
    for _ in range(warmup):
        fn()
    before = launches()
    dev_ms, host_ms = _time_steps(fn, runs, torch.device(device))
    return dev_ms, host_ms, launches_since(before)


def median_ms(fn, device, runs: int, warmup: int = WARMUP):
    """(device ms, host ms): the medians of time_calls."""
    dev_ms, host_ms, _ = time_calls(fn, device, runs, warmup)
    return statistics.median(dev_ms), statistics.median(host_ms)


def emit(line: dict, out=None) -> int:
    """Print the line as JSON, last on stdout; also write it to `out` when
    given. Returns the exit code 0."""
    text = json.dumps(line)
    print(text, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    return 0
