"""The reference configuration's yardstick and its cell reference.view:
scene_ref's grid against the port's build_volume, reference_ref's frame
against the port's plain 4-channel sweep, the K4 count against a hand
count, a whole run of the cell at the tiny size of tiny.py on the CPU
(sound: correct; with a fault planted in the program, or the TF32
control in its place: not correct), and the new yardstick files import
nothing of the program."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import harness, reference_ref, roofline_ref, scene_ref
from benchmark import plan as bplan
from benchmark.tests import test_bench_imports as imports
from benchmark.tests import tiny

CELL = "reference.view"
CONFIG = harness.load_json(harness.BENCH, "configs", "reference.json")
RTOL, ATOL = 2e-4, 2e-5  # the port's K4 tests (tests/test_torch_sweep_ref.py)


def _volume(size=16):
    return {**CONFIG["volume"], "size": size}


def _med():
    return {**CONFIG["medium"], "background": CONFIG["render"]["background"]}


def _cam(eye, width=32, height=24):
    return {"eye": list(eye), "center": [0.0, 0.0, 0.0], "up": [0.0, 0.0, 1.0],
            "fov_y_degrees": 45.0, "width": width, "height": height}


def test_scene_is_the_ports_volume():
    from volumetricrenderer_tpu_torch.config import VolumeConfig
    from volumetricrenderer_tpu_torch.models.scene import build_volume
    got = scene_ref.make_grid(_volume(), 1, "cpu")  # the preset's seeds 1..4
    want = build_volume(VolumeConfig(size=16), device="cpu")
    assert got.shape == want.shape == (16, 16, 16, 4)
    for c in range(4):
        assert torch.equal(got[..., c], want[..., c]), c
    assert not torch.equal(scene_ref.make_grid(_volume(), 2, "cpu"), got)


@pytest.mark.parametrize("eye", [(3.0, 3.0, 3.0), (-3.5, 1.0, 2.0),
                                 (0.5, -3.0, -3.2)])
def test_reference_is_the_ports_plain_sweep(eye):
    import volumetricrenderer_tpu_torch as T
    from volumetricrenderer_tpu_torch.ops.camera import look_at_camera
    grid = scene_ref.make_grid(_volume(), 7, "cpu")
    scroll = torch.tensor(np.random.default_rng(3).uniform(-2.0, 2.0, (4, 3)),
                          dtype=torch.float32)
    cam = _cam(eye)
    plan = bplan.make_plan(cam, grid.shape[:3], "cpu")
    want = reference_ref.render(grid, plan, _med(), scroll)
    medium = T.MediumConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in CONFIG["medium"].items()})
    cfg = T.RenderConfig(quadrature="sliced")
    with torch.no_grad():
        got = T.render_image(grid, look_at_camera(eye, (0, 0, 0), (0, 0, 1),
                                                  45.0, 32, 24),
                             cfg, medium, scroll=scroll)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert float(want[..., 3].max()) == 1.0
    moved = reference_ref.render(grid, plan, _med(), None)
    assert float((moved - want).abs().max()) > 1e-3  # the scroll is read


def test_k4_count_matches_a_hand_count():
    """In absorption every sample in the box and in front of the eye
    counts; a line is a row or a column of a slice that holds one."""
    grid = torch.rand((6, 5, 4, 4), generator=torch.Generator().manual_seed(0))
    cam = {**_cam((0.3, -0.2, 3.0), 10, 8), "up": [0.0, 1.0, 0.0]}
    plan = bplan.make_plan(cam, grid.shape[:3], "cpu", force_dims=(7, 9))
    counts = reference_ref.Counts("cpu")
    reference_ref.render(grid, plan, _med(), None, counts=counts)
    e = [float(x) for x in plan["eye01"]]
    samples = lines = 0
    for z in plan["slice_z"].tolist():
        if (z - e[0]) * plan["sign"] <= 0.0:
            continue
        rows = [0.0 <= e[1] + (z - e[0]) * v <= 1.0
                for v in plan["v_grid"].tolist()]
        cols = [0.0 <= e[2] + (z - e[0]) * u <= 1.0
                for u in plan["u_grid"].tolist()]
        samples += sum(rows) * sum(cols)
        lines += (sum(rows) + sum(cols)) if sum(rows) and sum(cols) else 0
    assert counts.read() == (samples, lines) and samples > 0
    S, A, B, Hb, Wb = 4, 5, 6, 7, 8
    assert roofline_ref.work(100, 10, S, A, B, Hb, Wb) == (
        43 * 100 + 30 * 10,
        4 * (4 * S * A * B + S + Hb + Wb + 20 + 5 * Hb * Wb))


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """tiny.py's copy, its cell profiling frames 1 to 3 (a few CPU frames
    fill the tiny window)."""
    h, root = tiny.make_copy(tmp_path_factory.mktemp("reference_view"))
    path = root / "benchmark" / "workloads" / (CELL + ".json")
    workload = json.loads(path.read_text())
    workload["profile"] = [1, 3]
    path.write_text(json.dumps(workload))
    return h


def _run(h, trace=0, seed=2**31 + 99):
    """A run whose window holds the profiled frames on a loaded CPU too."""
    result, _ = h.run_cell(CELL, seed, 1.5, trace, "cpu")
    return result


def test_sound_run_is_correct(copy):
    result = _run(copy)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 4
    assert set(result["metrics"]) == {"anim_frames_per_s", "frame_ms_p95",
                                      "setup_s"}
    result = _run(copy, trace=1, seed=3000000017)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"device_idle_pct.anim",
                                      "ref_layers_ms"}  # no K4 on the CPU


def _frame_altered(mp):
    import importlib
    render = importlib.import_module("volumetricrenderer_tpu_torch.render")
    orig = render.render_image
    mp.setattr(render, "render_image", lambda *a, **kw: orig(*a, **kw) * 1.01)


def _scroll_dropped(mp):
    from volumetricrenderer_tpu_torch.kernels import sweep_ref_fwd
    orig = sweep_ref_fwd._channel_offsets
    mp.setattr(sweep_ref_fwd, "_channel_offsets",
               lambda medium, scroll, *a, **kw: orig(medium, None, *a, **kw))


def _channel_unscaled(mp):
    from volumetricrenderer_tpu_torch.kernels import sweep_ref_fwd
    orig = sweep_ref_fwd.sweep_ref_inputs

    def inputs(gperm4, plan, cfg, medium, *a, **kw):
        scales = list(medium.channel_coord_scale)
        scales[2] = 1.0
        medium = dataclasses.replace(medium,
                                     channel_coord_scale=tuple(scales))
        return orig(gperm4, plan, cfg, medium, *a, **kw)
    mp.setattr(sweep_ref_fwd, "sweep_ref_inputs", inputs)


@pytest.mark.parametrize("fault", [_frame_altered, _scroll_dropped,
                                   _channel_unscaled],
                         ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(copy, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(copy)
    assert not result["correct"], result["checks"]


def test_control_is_not_correct(copy):
    from benchmark import control
    checks = control.readings(CELL, 2**31 + 5, "tf32", "cpu", bench=None,
                              harness_module=copy)
    assert not all(v <= lim for _, v, lim in checks), checks


@pytest.mark.parametrize("name", ["reference_ref.py", "scene_ref.py",
                                  "roofline_ref.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert imports.PORT not in set(imports._imports(imports.BENCH / name))


@pytest.mark.gpu
def test_sound_run_on_the_card(copy, cuda_device):
    """The same run at the tiny size through K4."""
    result, _ = copy.run_cell(CELL, 2**31 + 101, 0.5, 1, str(cuda_device))
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0.0 < result["metrics"]["sweep_ref_fwd_roofline_pct"]["value"] \
        <= 100.0
