#!/usr/bin/env python3
"""Run one cell of the benchmark of volumetricrenderer_tpu_torch once:

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks
for. The cell is an entry of BENCHMARK.json's "workloads"; harness.py
says where its files are. With --trace 0 the last line on stdout holds
the cell's end-to-end metrics, with --trace 1 its per-layer metrics, the
profiled stretch's busy and window seconds and a breakdown; both hold
`correct` and, last, the numbers compared against their limits, which are
also the last lines on stderr. The process runs on one core with one host
thread (harness.pin_to_one_core). Exits non-zero, printing no result, where
no CUDA device is present or fewer than the cell asks for, where a module
of JAX or of the JAX package is loaded once the window has closed, and
where any part of the run fails.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.set_caches()
    harness.pin_to_one_core()
    import torch
    torch.set_num_threads(1)
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.load_cell(args.workload, bench)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"no result: the cell needs {chips} CUDA device(s), "
                    f"{torch.cuda.device_count()} visible")
        return 2
    result, checks = harness.run_cell(args.workload, args.seed,
                                      args.seconds, args.trace, "cuda",
                                      T_START, bench)
    harness.log(f"correct: {result['correct']}")
    for name, value, limit in checks:
        harness.log(f"check {name}: {value!r} (limit {limit!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
