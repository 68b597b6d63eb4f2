"""The reference_fit configuration and its cell reference.fit, at the
tiny size of tiny.py on the CPU (the 128^3 x 4 medium cut to 16^3 x 4, the
1280x720 target to 32x24): a sound run is correct and reports the cell's
metrics; a traced run reads the fit step's parts and the channel layers;
each fault planted in the program (the state left unchanged, half the
batch out of the loss, the gradient x1.01, one channel's gradient zeroed,
the rendered frame x1.01) and the control (the reference in TF32 in the
program's place) make `correct` false; the K5 count; and the new
reference and yardstick import nothing of the program, the driver nothing
of JAX and the program only inside its functions."""
import ast
import json
import math

import pytest
import torch

from benchmark import (harness, reference_ref, reference_ref_fit,
                       roofline_ref_bwd)
from benchmark import plan as bplan
from benchmark.tests import test_bench_imports as imports
from benchmark.tests import tiny
from benchmark.tests.test_bench_faults import (_frame_altered, _half_batch,
                                               _state_unchanged)

CELL = "reference.fit"
PER_LAYER = ("device_idle_pct.train", "adam_ms", "fit_wait_ms",
             "render_ms.fit", "backward_ms.fit", "guard_ms",
             "adam_roofline_pct", "ref_layers_ms.fit")
DEVICE_ONLY = ("sweep_ref_bwd_roofline_pct",
               "sweep_ref_fwd_roofline_pct.train")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    # One thread, as a run has (run.py).
    torch.set_num_threads(1)
    h, root = tiny.make_copy(tmp_path_factory.mktemp("reference_fit"))
    path = root / "benchmark" / "workloads" / (CELL + ".json")
    workload = json.loads(path.read_text())
    workload["fit"]["grid_size"] = tiny.SIZE
    workload["timing_steps"] = 10
    path.write_text(json.dumps(workload))
    return h


def test_cell_is_the_reference_medium_fitted(copy):
    cell = copy.load_cell(CELL)
    assert cell.entry["chips"] == 1 and cell.workload["driver"] == "fit_ref"
    assert cell.config["medium"]["combine"] == "reference"
    assert not cell.config["render"]["emission"]
    assert cell.workload["fit"]["learning_rate"] == 0.05
    assert cell.workload["fit"]["init"] == reference_ref_fit.INIT
    assert cell.end_to_end == ["train_rays_per_s", "setup_s"]
    assert set(cell.per_layer) == set(PER_LAYER) | set(DEVICE_ONLY)
    assert set(cell.workload["limits"]) == {
        "loss_gap", "grad_norm_gap", "change_norm_gap", "frame_rel_err"}


def test_fit_configuration_fits_the_view_scene():
    """reference_fit is a configuration of its own (its source names the
    fit) over the very scene, camera and medium reference.view draws."""
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    entries = {c["name"]: c for c in bench["configs"]}
    fit_cfg = harness.load_cell(CELL, bench).config
    view_cfg = harness.load_cell("reference.view", bench).config
    assert fit_cfg["name"] == "reference_fit"
    assert entries["reference_fit"]["source"] == fit_cfg["source"] \
        != entries["reference"]["source"]
    assert entries["reference_fit"]["file"] != entries["reference"]["file"]
    for key in ("volume", "camera", "render", "medium", "light"):
        assert fit_cfg[key] == view_cfg[key], key


def test_sound_run_is_correct(copy):
    result, _ = copy.run_cell(CELL, 2**31 + 601, 0.3, 0, "cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert set(result["checks"]) == {"loss_gap", "grad_norm_gap",
                                     "change_norm_gap", "frame_rel_err"}


def test_traced_run_reads_the_parts(copy):
    from volumetricrenderer_tpu_torch.utils import clock
    clock.clear_spans()
    result, _ = copy.run_cell(CELL, 2**31 + 613, 3.0, 1, "cpu")
    assert result["correct"], result["checks"]
    # No CUDA kernel runs on the CPU: the rooflines find nothing to read.
    assert set(result["metrics"]) == set(PER_LAYER)
    for name in PER_LAYER:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    assert result["metrics"]["ref_layers_ms.fit"]["unit"] == "ms"


def _gradient_altered(mp):
    from volumetricrenderer_tpu_torch.kernels import sweep_ref_bwd
    orig = sweep_ref_bwd.sweep_ref_bwd_reference
    mp.setattr(sweep_ref_bwd, "sweep_ref_bwd_reference",
               lambda *a, **kw: orig(*a, **kw) * 1.01)


def _channel_zeroed(mp):
    from volumetricrenderer_tpu_torch.kernels import sweep_ref_bwd
    orig = sweep_ref_bwd.sweep_ref_bwd_reference

    def zeroed(*a, **kw):
        dL = orig(*a, **kw).clone()
        dL[:, 2] = 0.0
        return dL
    mp.setattr(sweep_ref_bwd, "sweep_ref_bwd_reference", zeroed)


FAULTS = (_state_unchanged, _half_batch, _gradient_altered, _channel_zeroed,
          _frame_altered)


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__[1:] for f in FAULTS])
def test_fault_is_not_correct(copy, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = copy.run_cell(CELL, 2**31 + 617, 0.3, 0, "cpu")
    assert not result["correct"], result["checks"]


def test_control_is_not_correct(copy):
    from benchmark import control
    checks = control.readings(CELL, 2**31 + 619, "tf32", "cpu", bench=None,
                              harness_module=copy)
    assert not all(v <= lim for _, v, lim in checks), checks


def test_k5_count_matches_a_hand_count():
    """K5's absorption count: roofline_ref_bwd's work of the reference's
    own sample count (the samples and lines roofline_ref counts for K4)."""
    grid = torch.rand((6, 5, 4, 4), generator=torch.Generator().manual_seed(0))
    cam = {"eye": [0.3, -0.2, 3.0], "center": [0.0, 0.0, 0.0],
           "up": [0.0, 1.0, 0.0], "fov_y_degrees": 45.0, "width": 10,
           "height": 8}
    med = {"channel_coord_scale": [1.0, 0.8, 0.75, 0.7],
           "channel_scroll_weight": [0.0, 0.2, 0.25, 0.3],
           "sample_scale": 0.2, "density": 1.0, "background": [0, 0, 0]}
    plan = bplan.make_plan(cam, grid.shape[:3], "cpu")
    tally = reference_ref.Counts("cpu")
    reference_ref.render(grid, plan, med, None, counts=tally)
    run = {"config": {"render": {"sweep_supersample": 1.5}}, "med": med}
    item = {"grid": grid, "camera": cam, "scroll": None}
    samples, lines, S, A, B, Hb, Wb = roofline_ref_bwd.counts(run, item)
    assert (samples, lines) == tally.read() and samples > 0
    assert (S, A, B) == tuple(grid.shape[p] for p in plan["perm"])
    assert roofline_ref_bwd.work(100, 10, 4, 5, 6, 7, 8) == (
        85 * 100 + 30 * 10,
        4 * (2 * 4 * 4 * 5 * 6 + 4 + 7 + 8 + 20 + 2 * 7 * 8))


@pytest.mark.parametrize("name", ["reference_ref_fit.py",
                                  "roofline_ref_bwd.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert imports.PORT not in set(imports._imports(imports.BENCH / name))


def test_driver_imports_the_program_only_when_run():
    path = imports.BENCH / "drivers" / "fit_ref.py"
    tree = ast.parse(path.read_text())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add((node.module or "").split(".")[0])
    assert imports.PORT not in top
    assert not set(imports._imports(path)) & imports.JAX
