"""`correct` comes out false when the timed path is broken underneath: a
whole run of each cell (the look for a card skipped, at the tiny size of
tiny.py, on the CPU), with one fault planted in the program for each kind
the cell can have; and the control, the reference in TF32 put in the
program's place, fails a number of every cell. A sound run is correct."""
import math

import pytest
import torch

from benchmark.tests import tiny

CELLS = ("config3.fit", "config4.orbit", "config3.view", "config4.newcam")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    h, _ = tiny.make_copy(tmp_path_factory.mktemp("faults"))
    return h


def _run(h, cell, seed=2**31 + 99):
    result, checks = h.run_cell(cell, seed, 0.3, 0, "cpu")
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(copy, cell):
    result = _run(copy, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


def _state_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(mp):
    import volumetricrenderer_tpu_torch.fit as fit
    import volumetricrenderer_tpu_torch.ops.sweep as sweep
    seen = {}
    fit_grid, render = fit.fit_grid, sweep.sweep_render

    def fit_spy(target_rgb, *a, **kw):
        seen["target"] = target_rgb
        return fit_grid(target_rgb, *a, **kw)

    def half(*a, **kw):
        img = render(*a, **kw)
        t = seen["target"]
        h = img.shape[0] // 2
        rgb = torch.cat([t[:h] + math.sqrt(2.0) * (img[:h, :, :3] - t[:h]),
                         t[h:]], dim=0)
        return torch.cat([rgb, img[..., 3:]], dim=-1)

    mp.setattr(fit, "fit_grid", fit_spy)
    mp.setattr(sweep, "sweep_render", half)


def _gradient_altered(mp):
    import volumetricrenderer_tpu_torch.kernels.sweep_bwd as bwd
    orig = bwd.sweep_bwd_reference
    mp.setattr(bwd, "sweep_bwd_reference",
               lambda *a, **kw: orig(*a, **kw) * 1.01)


def _frame_altered(mp):
    import importlib
    # The package's `render` is render_image; the module is imported by name.
    render = importlib.import_module("volumetricrenderer_tpu_torch.render")
    orig = render.render_image
    mp.setattr(render, "render_image", lambda *a, **kw: orig(*a, **kw) * 1.01)


def _light_altered(mp):
    import volumetricrenderer_tpu_torch.ops.lighting as lighting
    orig = lighting.light_transmittance_volume
    mp.setattr(lighting, "light_transmittance_volume",
               lambda *a, **kw: orig(*a, **kw) * 0.99)


FAULTS = [("config3.fit", _state_unchanged), ("config3.fit", _half_batch),
          ("config3.fit", _gradient_altered)] \
    + [(c, _frame_altered) for c in CELLS[1:]] \
    + [(c, _light_altered) for c in ("config4.orbit", "config4.newcam")]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(copy, cell, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(copy, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(copy, cell):
    from benchmark import control
    checks = control.readings(cell, 2**31 + 5, "tf32", "cpu", bench=None,
                              harness_module=copy)
    assert not all(v <= lim for _, v, lim in checks), checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_the_card(copy, cell, cuda_device):
    """The same run at the tiny size through the CUDA kernels."""
    result, _ = copy.run_cell(cell, 2**31 + 101, 0.5, 0, str(cuda_device))
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
