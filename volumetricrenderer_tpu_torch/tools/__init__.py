"""The JAX repository's workload tools (tools/ at the repository root),
ported as runners of this package, one module each:

    python -m volumetricrenderer_tpu_torch.tools.NAME

    fit_config3     config 3's fit          anim_config4   config 4's orbit
    scale512        config 5's volume       serve_local    serve's frames
    measure_warp    the screen warp         trace_flagship per-op profile
    profile_parts   the step's stages, one by one

and the sharded path's entry points (__graft_entry__.dryrun_multichip,
tools/sharded_tpu.py and tools/scaling_rehearsal.py there), each over one
process per rank (spawn_ranks below; SHARDED_RUNNERS):

    multichip       one shadowed train step on an n-rank (data, slab) mesh
    sharded_step    the sharded frame and step beside the unsharded ones
    scaling_rehearsal  the sharded frame and step per mesh shape

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

A sharded runner's `--ranks N` starts N processes (torch.multiprocessing,
spawn), rank r on cuda:r with NCCL (gloo ranks on the CPU with `--device
cpu`), joined through parallel/bootstrap.initialize_distributed at a
file:// rendezvous in a temporary directory; rank 0 prints the line. On
CUDA, N above the visible cards fails before any process starts: one card
per rank, no fallback to gloo, no shared card, no smaller mesh. Under
torchrun (RANK, WORLD_SIZE and LOCAL_RANK set) the runner runs in place,
one rank per process torchrun started, and spawns nothing:

    torchrun --nproc_per_node=4 -m volumetricrenderer_tpu_torch.tools.multichip
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import sys
import tempfile

import torch
import torch.distributed as dist

from ..bench import _power_limit_w, _time_steps
from ..kernels import sweep_bwd, sweep_fwd, sweep_ref_bwd, sweep_ref_fwd
from ..ops import sweep as ops_sweep
from ..parallel import bootstrap

__all__ = ["RUNNERS", "SHARDED_RUNNERS", "WARMUP", "log", "env_int",
           "parse_args", "device_of", "launches", "launches_since",
           "time_calls", "median_ms", "Counts", "emit", "under_torchrun",
           "world_size", "spawn_ranks"]

RUNNERS = ("fit_config3", "anim_config4", "scale512", "serve_local",
           "measure_warp", "trace_flagship")
SHARDED_RUNNERS = ("multichip", "sharded_step", "scaling_rehearsal")
TORCHRUN_NAMES = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
WARMUP = 2  # untimed calls before the timed ones, in every runner
KERNELS = {"sweep_fwd": sweep_fwd, "sweep_bwd": sweep_bwd,
           "sweep_ref_fwd": sweep_ref_fwd, "sweep_ref_bwd": sweep_ref_bwd}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def parse_args(doc: str, argv=None, ranks=None):
    """--device and --out, the two arguments every runner takes, and
    --ranks for a sharded runner (`ranks`: the help text of its default)."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    if ranks is not None:
        parser.add_argument("--ranks", type=int, default=None,
                            help=f"processes, one per card (default: "
                                 f"{ranks}; under torchrun its WORLD_SIZE)")
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

    def read_ranks(self) -> dict:
        """read() of this rank, and "launches_per_rank": every rank's
        launches, gathered over the running process group."""
        got = self.read()
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, got["launches"])
        return {**got, "launches_per_rank": per_rank}


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


def under_torchrun() -> bool:
    """Whether torch's launcher started this process (RANK, WORLD_SIZE and
    LOCAL_RANK set)."""
    return all(name in os.environ for name in TORCHRUN_NAMES)


def world_size(ranks, default: int) -> int:
    """The number of ranks: `ranks` when given, else torchrun's WORLD_SIZE
    under torchrun, else `default`. Raises ValueError when `ranks` differs
    from torchrun's world."""
    if under_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if ranks is not None and ranks != world:
            raise ValueError(f"--ranks {ranks} under torchrun, whose "
                             f"WORLD_SIZE is {world}")
        return world
    return default if ranks is None else ranks


def _as_rank(fn, args, device_type: str, local: int, **join):
    """Join the process group (parallel/bootstrap.initialize_distributed
    with `join`, on the local card `local` on CUDA), run fn(device, *args)
    and leave the group. Returns fn's result."""
    cuda = device_type == "cuda"
    if not bootstrap.initialize_distributed(
            local_device_ids=local if cuda else None, retries=1,
            device=device_type, **join):
        raise RuntimeError("spawn_ranks: no process group was started")
    try:
        return fn(torch.device("cuda", local) if cuda
                  else torch.device("cpu"), *args)
    finally:
        dist.destroy_process_group()
        bootstrap._initialized = False


def _rank_main(rank, world, device_type, init_file, out_file, fn, args):
    """One spawned rank at the file:// rendezvous init_file; rank 0
    pickles fn's result to out_file."""
    if device_type != "cuda":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    result = _as_rank(fn, args, device_type, rank,
                      coordinator_address=f"file://{init_file}",
                      num_processes=world, process_id=rank)
    if rank == 0:
        with open(out_file, "wb") as f:
            pickle.dump(result, f)


def spawn_ranks(fn, world: int, device, *args):
    """Run fn(device, *args) on `world` ranks of one process group, rank r
    on its own device (cuda:r, NCCL; or the CPU, gloo), and return rank 0's
    result (None on the other ranks under torchrun). fn is a module-level
    function (it is pickled by name into each process) that builds its
    mesh with parallel/mesh.make_mesh over the running group.

    Spawned: `world` processes by torch.multiprocessing (spawn), joined
    at a file:// rendezvous in a temporary directory; a rank that raises
    ends the others and raises here. On CUDA, a world above
    torch.cuda.device_count() raises RuntimeError before any process
    starts. Under torchrun, this process is one rank: it joins the group
    torchrun configured (its LOCAL_RANK's card) and runs fn in place."""
    import torch.multiprocessing as mp
    device_type = torch.device(device).type
    if world < 1:
        raise ValueError(f"spawn_ranks: {world} ranks")
    if under_torchrun():
        result = _as_rank(fn, args, device_type,
                          int(os.environ["LOCAL_RANK"]))
        return result if int(os.environ["RANK"]) == 0 else None
    if device_type == "cuda":
        visible = torch.cuda.device_count()
        if world > visible:
            raise RuntimeError(f"{world} ranks need one CUDA device each: "
                               f"{visible} visible")
    with tempfile.TemporaryDirectory(prefix="volt-ranks-") as tmp:
        out_file = os.path.join(tmp, "rank0.pkl")
        mp.spawn(_rank_main, args=(world, device_type,
                                   os.path.join(tmp, "init"), out_file, fn,
                                   args), nprocs=world, join=True)
        with open(out_file, "rb") as f:
            return pickle.load(f)
