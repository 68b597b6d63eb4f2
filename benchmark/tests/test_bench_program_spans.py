"""The five per-layer metrics that read the program's own spans
(program_spans.py) are present, finite and positive in a traced run of
their cell (tiny.py's size, on the CPU), and absent, without an error,
where the program records no spans or its spans carry no device
interval."""
import json
import math

import pytest

from benchmark.tests import tiny

READS = {"config3.fit": ("warp_ms.train", "adam_ms", "fit_wait_ms"),
         "config4.orbit": ("light_host_ms",),
         "config4.newcam": ("plan_host_ms",)}
# Each window has to reach the end of its profiled steps or frames, also
# on a loaded machine.
SECONDS = {"config3.fit": 3.0, "config4.orbit": 3.0, "config4.newcam": 3.0}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    import torch
    # One thread, as a run has (run.py): beside other test workers, torch's
    # own pool makes a step of the tiny fit take a second.
    torch.set_num_threads(1)
    h, root = tiny.make_copy(tmp_path_factory.mktemp("spans"))
    # The fit's window runs as many steps as set-up's pace says fill it:
    # paced between two tenth-step writes, not over tiny.py's two steps
    # (which a first call's cost can stretch to a window of three).
    path = root / "benchmark" / "workloads" / "config3.fit.json"
    fit = json.loads(path.read_text())
    fit["timing_steps"] = 20
    path.write_text(json.dumps(fit))
    return h


@pytest.mark.parametrize("cell", sorted(READS))
def test_traced_run_reads_the_program_spans(copy, cell):
    from volumetricrenderer_tpu_torch.utils import clock
    clock.clear_spans()
    result, _ = copy.run_cell(cell, 2**31 + 313, SECONDS[cell], 1, "cpu")
    assert result["correct"], result["checks"]
    for name in READS[cell]:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
        assert result["metrics"][name]["unit"] == "ms"


@pytest.mark.parametrize("cell", sorted(READS))
def test_no_program_spans_no_metric(copy, cell, monkeypatch):
    from volumetricrenderer_tpu_torch.utils import clock
    monkeypatch.delattr(clock, "spans")
    result, _ = copy.run_cell(cell, 2**31 + 317, 0.3, 1, "cpu")
    assert result["correct"], result["checks"]
    assert not set(READS[cell]) & set(result["metrics"])


def test_no_device_interval_no_metric(copy, monkeypatch):
    from volumetricrenderer_tpu_torch.utils import clock
    span = clock.span
    monkeypatch.setattr(clock, "span",
                        lambda name, device=False: span(name))
    result, _ = copy.run_cell("config3.fit", 2**31 + 319,
                              SECONDS["config3.fit"], 1, "cpu")
    assert result["correct"], result["checks"]
    assert "fit_wait_ms" in result["metrics"]
    assert not {"warp_ms.train", "adam_ms"} & set(result["metrics"])
