#!/usr/bin/env python3
"""The readings that set a cell's limits: the numbers its check compares,
for the program on a short window and for the control put in the
program's place (the reference one precision below the configuration's:
TF32), and for a driver's planted faults, at the cell's own size, one
seed after another in one process:

    python3 benchmark/control.py --workload CELL --seeds 1,2,3
        [--seconds 3] [--faults half_batch]

Prints one JSON line per seed and reading ({"seed", "side", "checks"}).
The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def readings(cell_name, seed, side, device="cuda", bench=None,
             harness_module=harness):
    """[(name, value, limit)] of the control or a fault ("tf32" or a
    driver's fault name) for one seed, with no program in the process's
    path. harness_module: the harness whose files are read (a copy's, in
    the tests)."""
    h = harness_module
    cell = h.load_cell(cell_name, bench)
    ctx = h.Ctx(cell, seed, 0.0, False, device)
    driver = h.load_module(
        os.path.join(h.BENCH, "drivers", cell.workload["driver"] + ".py"),
        "bench_driver_" + cell.workload["driver"])
    state, answers = driver.control(ctx, side)
    return driver.check(ctx, state, {}, answers)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    harness.set_caches()
    harness.pin_to_one_core()
    import torch
    torch.set_num_threads(1)
    sides = ["tf32"] + [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run_cell(args.workload, seed, args.seconds, 0,
                                     "cuda")
        print(json.dumps({"seed": seed, "side": "program",
                          "checks": result["checks"],
                          "metrics": result["metrics"]}), flush=True)
        for side in sides:
            checks = readings(args.workload, seed, side)
            print(json.dumps({"seed": seed, "side": side, "checks": {
                n: {"value": v, "limit": lim} for n, v, lim in checks}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
