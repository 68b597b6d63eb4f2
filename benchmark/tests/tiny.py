"""A copy of the benchmark at a size the CPU runs in seconds: every
configuration cut to a 16^3 grid and a 32x24 image, the fit's timing to
two steps, in a temporary directory beside a BENCHMARK.json of its own.
Its harness is the copy's, loaded by path."""
import json
import os
import shutil

from benchmark import harness

SIZE, WIDTH, HEIGHT = 16, 32, 24


def make_copy(tmp_path, extra_cells=()):
    """(the copy's harness module, its root). extra_cells: (entry, workload
    file contents, metric names) triples: each cell a new file, its entry
    added to BENCHMARK.json and to the "workloads" of those metrics, with
    no other edit."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for entry in bench["configs"]:
        path = root / entry["file"]
        cfg = json.loads(path.read_text())
        cfg["volume"]["size"] = SIZE
        cfg["camera"]["width"], cfg["camera"]["height"] = WIDTH, HEIGHT
        if "fit" in cfg:
            cfg["fit"]["grid_size"] = SIZE
        path.write_text(json.dumps(cfg))
    wl = root / "benchmark" / "workloads" / "config3.fit.json"
    fit = json.loads(wl.read_text())
    fit["timing_steps"] = 2
    wl.write_text(json.dumps(fit))
    for entry, workload, metrics in extra_cells:
        bench["workloads"].append(entry)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in metrics:
                m["workloads"].append(entry["name"])
        (root / "benchmark" / "workloads" / (entry["name"] + ".json")) \
            .write_text(json.dumps(workload))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mod = harness.load_module(os.path.join(root, "benchmark", "harness.py"),
                              f"bench_harness_copy_{id(tmp_path)}")
    return mod, root
