"""config5.fit at a size the CPU runs in seconds (tiny.py's copy, its
config5 cut to a 16^3 cloud and a 32x18 target, 16:9 as 1920x1080, two
timing steps): a sound run is correct, with every metric of the cell; a
traced run reads the fit step's parts; each fault planted in the program
(the state left unchanged, the gradient x1.01, half the batch out of the
loss) and the control (the reference in TF32 in the program's place)
make `correct` false."""
import json
import math

import pytest
import torch

from benchmark.tests import tiny
from benchmark.tests.test_bench_faults import (_gradient_altered,
                                               _half_batch, _state_unchanged)

CELL = "config5.fit"
WIDTH, HEIGHT = 32, 18
PER_LAYER = ("device_idle_pct.train", "adam_ms", "warp_ms.train",
             "fit_wait_ms", "render_ms.fit", "backward_ms.fit", "guard_ms",
             "adam_roofline_pct")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    # One thread, as a run has (run.py).
    torch.set_num_threads(1)
    h, root = tiny.make_copy(tmp_path_factory.mktemp("config5"))
    path = root / "benchmark" / "configs" / "config5.json"
    cfg = json.loads(path.read_text())
    cfg["camera"]["width"], cfg["camera"]["height"] = WIDTH, HEIGHT
    path.write_text(json.dumps(cfg))
    path = root / "benchmark" / "workloads" / (CELL + ".json")
    fit = json.loads(path.read_text())
    fit["timing_steps"] = 20
    path.write_text(json.dumps(fit))
    return h


def test_config5_is_the_published_recipe(copy):
    cell = copy.load_cell(CELL)
    c = cell.config
    assert c["volume"] == {"kind": "cloud", "size": tiny.SIZE}
    assert (c["camera"]["width"], c["camera"]["height"]) == (WIDTH, HEIGHT)
    assert c["render"]["quadrature"] == "sliced" and c["render"]["emission"]
    assert c["render"]["sweep_supersample"] == 1.5
    assert c["medium"] == {"combine": "single", "density": 8.0,
                           "sample_scale": 0.2}
    assert c["light"]["shadow_steps"] == 0
    assert (c["fit"]["learning_rate"], c["fit"]["init"]) == (0.05, 0.1)
    assert cell.entry["chips"] == 1
    assert cell.end_to_end == ["train_rays_per_s", "setup_s"]
    assert set(cell.per_layer) == set(PER_LAYER) | {"sweep_bwd_roofline_pct"}


def test_sound_run_is_correct(copy):
    result, _ = copy.run_cell(CELL, 2**31 + 523, 0.3, 0, "cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}


def test_traced_run_reads_the_parts(copy):
    from volumetricrenderer_tpu_torch.utils import clock
    clock.clear_spans()
    result, _ = copy.run_cell(CELL, 2**31 + 541, 3.0, 1, "cpu")
    assert result["correct"], result["checks"]
    for name in PER_LAYER:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    for name in ("device_idle_pct.train", "adam_roofline_pct"):
        assert result["metrics"][name]["value"] <= 100.0
        assert result["metrics"][name]["unit"] == "%"


FAULTS = (_state_unchanged, _gradient_altered, _half_batch)


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__[1:] for f in FAULTS])
def test_fault_is_not_correct(copy, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = copy.run_cell(CELL, 2**31 + 547, 0.3, 0, "cpu")
    assert not result["correct"], result["checks"]


def test_control_is_not_correct(copy):
    from benchmark import control
    checks = control.readings(CELL, 2**31 + 557, "tf32", "cpu", bench=None,
                              harness_module=copy)
    assert not all(v <= lim for _, v, lim in checks), checks
