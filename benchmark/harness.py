"""The benchmark's generic core: find a cell's files by name, run its
driver once, read its metrics, decide `correct`.

Everything that belongs to one configuration, cell or metric is a file of
its own, found by the name BENCHMARK.json gives it:

  configs/<config>.json     the configuration as it is run (program
                            config fields, sizes, the orbit, the fit)
  workloads/<cell>.json     the cell: its configuration, its driver, its
                            traffic parameters (traffic.py reads them),
                            what a traced run profiles, and the limit of
                            every number its check compares
  drivers/<driver>.py       setup(ctx), window(ctx, state),
                            check(ctx, state, run)
  metrics/<metric>.py       read(run) -> a number, or None where the run
                            holds nothing to read

A run: the cell's setup (inputs from the seed, the program's set-up and
warm-up), its window (`--seconds` of the timed path; with trace, spans
and a profiled stretch), the peak memory, then with trace the per-layer
readers, then the cell's check against the reference. The readers of a
cell are the metrics of BENCHMARK.json that list the cell under
"workloads", or that list none.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "volumetricrenderer_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def set_caches():
    """Every build and kernel cache at a fixed directory inside the
    checkout (before torch or the program is imported)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = os.path.join(CACHE, sub)


def pin_to_one_core():
    """Run the process, and every thread it starts, on one core (the last
    it may use), with one OpenMP thread. The host side of a frame is what
    the host-bound cells measure: free to move between cores, the same
    run's rate moved by up to a fifth from process to process; on one core
    by a few hundredths (PERF.md)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Top-level names of loaded modules the benchmark must not load,
    compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)
            if sys.modules[name] is not None}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict        # the BENCHMARK.json workloads entry
    workload: dict     # workloads/<cell>.json
    config: dict       # configs/<config>.json
    end_to_end: list   # metric names the cell reports with trace 0
    per_layer: list    # and with trace 1
    units: dict        # every metric's unit, by name


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def load_cell(name, bench=None) -> Cell:
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    workload = load_json(BENCH, "workloads", name + ".json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = load_json(ROOT, cfg_entry["file"])
    return Cell(name, entry, workload, config,
                [m["name"] for m in bench["end_to_end"] if _reports(m, name)],
                [m["name"] for m in bench["per_layer"] if _reports(m, name)],
                {m["name"]: m["unit"]
                 for m in bench["end_to_end"] + bench["per_layer"]})


class Ctx:
    """What a driver gets: the cell, the run's arguments, the device, the
    program's configuration objects and the reference's medium."""

    def __init__(self, cell: Cell, seed, seconds, trace, device):
        import torch
        self.cell, self.config, self.workload = cell, cell.config, \
            cell.workload
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device = torch.device(device)
        c = self.config
        self.med = {**c["medium"],
                    "early_stop_transmittance":
                        c["render"]["early_stop_transmittance"],
                    "background": c["render"]["background"],
                    "ambient": c["light"]["ambient"],
                    "light_color": c["light"]["color"],
                    "light_direction": c["light"]["direction"]}
        self.shadows = (c["light"]["shadow_steps"] > 0
                        and c["render"]["emission"])

    def program_configs(self):
        """(RenderConfig, MediumConfig, LightConfig) of the program, from
        the configuration file's fields."""
        from volumetricrenderer_tpu_torch.config import (LightConfig,
                                                         MediumConfig,
                                                         RenderConfig)
        c = self.config
        render = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in c["render"].items()}
        light = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in c["light"].items()}
        return (RenderConfig(**render), MediumConfig(**c["medium"]),
                LightConfig(**light))

    def limit(self, name):
        return self.workload["limits"][name]


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None,
             bench=None):
    """One run of a cell. Returns (result dict for the last line, the
    compared numbers [(name, value, limit)])."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, bench)
    ctx = Ctx(cell, seed, seconds, trace, device)
    driver = load_module(os.path.join(BENCH, "drivers",
                                      cell.workload["driver"] + ".py"),
                         "bench_driver_" + cell.workload["driver"])
    cuda = ctx.device.type == "cuda"
    if cuda:
        from volumetricrenderer_tpu_torch.kernels import build
        build.BUILD_DIR = os.path.join(CACHE, "cuda_build")
        torch.cuda.init()  # the allocator's statistics need a context
        torch.cuda.reset_peak_memory_stats(ctx.device)
    state = driver.setup(ctx)
    before = program_counters()
    run = driver.window(ctx, state)
    after = program_counters()
    log("program counters over the window, per attempt ("
        f"{run['attempted']}): " + ", ".join(
            f"{k} {(after[k] - before[k]) / run['attempted']:g}"
            for k in after))
    run["setup_s"] = run["t0"] - t_start
    run["med"], run["config"] = ctx.med, ctx.config
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded after the window: {found}")
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    state.release()
    if cuda:
        torch.cuda.empty_cache()
    metrics = {}
    names = cell.per_layer if trace else cell.end_to_end
    units = cell.units
    for metric in names:
        reader = load_module(os.path.join(BENCH, "metrics", metric + ".py"),
                             "bench_metric_" + metric.replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[metric] = {"value": value, "unit": units[metric]}
    t_check = time.perf_counter()
    checks = driver.check(ctx, state, run)
    log(f"check against the reference: "
        f"{time.perf_counter() - t_check:.2f} s")
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks) \
        and bool(checks)
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics,
              "device": device_block(ctx, peak, run)}
    prof = run.get("profile")
    if trace and prof is not None:
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def program_counters():
    """The program's own launch counters: the forward and backward sweep
    kernels' launches and the general (plain PyTorch) sweep's calls."""
    from volumetricrenderer_tpu_torch.kernels import sweep_bwd, sweep_fwd
    from volumetricrenderer_tpu_torch.ops import sweep
    return {"sweep_fwd.launches": sweep_fwd.launches,
            "sweep_bwd.launches": sweep_bwd.launches,
            "ops.sweep.general_calls": sweep.general_calls}


def device_block(ctx, peak, run):
    import torch
    if ctx.device.type != "cuda":
        block = {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": peak}
    else:
        block = {"platform": "gpu",
                 "kind": torch.cuda.get_device_name(ctx.device),
                 "count": ctx.cell.entry["chips"],
                 "memory_peak_bytes": peak,
                 "power_limit_w": power_limit_w()}
    prof = run.get("profile")
    if ctx.trace and prof is not None:
        block["busy_s"] = prof["busy_s"]
        block["window_s"] = prof["window_s"]
    return block


def power_limit_w():
    """The card's power limit from nvidia-smi, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
