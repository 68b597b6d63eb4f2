"""The harness finds every configuration, cell, driver and metric reader
by the name BENCHMARK.json gives it, a cell file dropped into a copy is
found with no edit, and BENCHMARK.json keeps the contract's shapes."""
import os
import re

import pytest

from benchmark import harness
from benchmark.tests import tiny

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.load_cell(cell, BENCH)
    assert os.path.exists(os.path.join(
        harness.BENCH, "drivers", c.workload["driver"] + ".py"))
    assert c.workload["config"] == c.entry["config"] == c.config["name"]
    for metric in c.end_to_end + c.per_layer:
        assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                           metric + ".py")), metric
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    assert set(c.workload["limits"]) >= {"frame_rel_err"} \
        or c.workload["driver"] == "fit"


def test_benchmark_json_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    cells = 24
    check = 2 + 14 * cells
    assert check * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_new_cell_file_is_found_without_edit(tmp_path):
    entry = {"name": "config3.view2", "config": "config3",
             "traffic": "ring_cycle", "chips": 1, "why": "a test cell"}
    workload = harness.load_json(harness.BENCH, "workloads",
                                 "config3.view.json")
    workload["traffic"]["order"] = "cycle"
    workload["profile"] = [0, 2]
    h, root = tiny.make_copy(tmp_path, [(entry, workload, (
        "frames_per_s", "frame_ms_p95", "device_idle_pct.frame"))])
    before = {p: open(p, "rb").read() for p in _files(root / "benchmark")
              if not p.endswith(".json")}
    result, checks = h.run_cell("config3.view2", 11, 0.3, 0, "cpu")
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                      "setup_s"}
    assert list(result)[-1] == "checks"
    after = {p: open(p, "rb").read() for p in before}
    assert before == after
    result, _ = h.run_cell("config3.view2", 12, 0.3, 1, "cpu")
    assert result["correct"] and "device_idle_pct.frame" in result["metrics"]


def _files(root):
    for d, _, fs in os.walk(root):
        for f in fs:
            yield os.path.join(d, f)
