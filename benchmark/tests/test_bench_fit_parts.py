"""The readers of the fit step's parts (render_ms.fit, backward_ms.fit,
guard_ms; fit_spans.py) and of the optimizer's roofline share
(adam_roofline_pct; optimizer_roofline.py) on spans laid out by hand: the
mean device interval per "fit.step", nothing where the program records no
such span or no spans at all; and the optimizer's 28 B a voxel against
the state torch's Adam keeps and writes."""
import os

import pytest
import torch

from benchmark import fit_spans, harness, optimizer_roofline, roofline

PARTS = {"render_ms.fit": "fit.render", "backward_ms.fit": "fit.backward",
         "guard_ms": "fit.guard"}


def _reader(metric):
    return harness.load_module(
        os.path.join(harness.BENCH, "metrics", metric + ".py"),
        "bench_metric_" + metric.replace(".", "_")).read


def _steps(parts, steps=4, t0=10_000_000_000):
    """Spans of `steps` fit steps 1 ms apart: a "fit.step" root each and,
    per name in `parts`, one span of device interval (k + 1) * its base
    (ns) in step k."""
    from volumetricrenderer_tpu_torch.utils.clock import Span
    out, sid = [], 0
    for k in range(steps):
        base = t0 + k * 1_000_000
        sid += 1
        root = sid
        out.append(Span("fit.step", root, None, k, 1, base, base + 900_000,
                        None))
        for name, ns in parts.items():
            sid += 1
            out.append(Span(name, sid, root, k, 1, base + 1000,
                            base + 2000, float(ns * (k + 1))))
    return out


def _run(monkeypatch, spans, **extra):
    from volumetricrenderer_tpu_torch.utils import clock
    monkeypatch.setattr(clock, "spans", lambda: spans)
    return {"t0": 9.0, "window_s": 2.0, **extra}


@pytest.mark.parametrize("metric", sorted(PARTS))
def test_part_is_its_span_per_step(metric, monkeypatch):
    spans = _steps({"fit.render": 3e6, "fit.backward": 5e6,
                    "fit.guard": 2e5, "fit.adam": 1e6})
    run = _run(monkeypatch, spans)
    base = {"fit.render": 3.0, "fit.backward": 5.0, "fit.guard": 0.2}
    # Steps k = 0..3 read (k + 1) * base: a mean of 2.5 * base.
    assert _reader(metric)(run) == pytest.approx(2.5 * base[PARTS[metric]])


@pytest.mark.parametrize("metric", sorted(PARTS))
def test_part_absent_reads_nothing(metric, monkeypatch):
    """A program without the span (the parent of these readers) has steps
    and fit.adam; the reader gives None, not 0."""
    run = _run(monkeypatch, _steps({"fit.adam": 1e6}))
    assert _reader(metric)(run) is None
    assert fit_spans.per_step_device_ms(run, "fit.adam") == \
        pytest.approx(2.5)


@pytest.mark.parametrize("metric", sorted(PARTS) + ["adam_roofline_pct"])
def test_no_program_spans_reads_nothing(metric, monkeypatch):
    from volumetricrenderer_tpu_torch.utils import clock
    monkeypatch.delattr(clock, "spans")
    grid = torch.empty((512,) * 3, device="meta")
    assert _reader(metric)({"t0": 9.0, "window_s": 2.0,
                            "profiled_work": [{"grid": grid}]}) is None


def test_part_outside_the_window_is_not_read(monkeypatch):
    run = _run(monkeypatch, _steps({"fit.render": 3e6}))
    run["t0"] = 11.0
    assert _reader("render_ms.fit")(run) is None


def test_adam_roofline_share(monkeypatch):
    grid = torch.empty((512,) * 3, device="meta")
    run = _run(monkeypatch, _steps({"fit.adam": 8e5}),
               profiled_work=[{"grid": grid}, {"grid": grid}])
    least = 28 * 512 ** 3 / 3.35e12
    assert least == pytest.approx(1.1218e-3, rel=1e-4)
    assert optimizer_roofline.least_s(512 ** 3) == pytest.approx(least)
    # fit.adam reads (k + 1) * 0.8 ms: a mean of 2 ms.
    assert _reader("adam_roofline_pct")(run) == \
        pytest.approx(100.0 * least / 2e-3)
    assert optimizer_roofline.least_s(256 ** 3) == \
        pytest.approx(1.402e-4, rel=1e-3)


def test_adam_roofline_needs_the_grid_and_the_span(monkeypatch):
    run = _run(monkeypatch, _steps({"fit.adam": 8e5}))
    assert _reader("adam_roofline_pct")(run) is None
    grid = torch.empty((8,) * 3, device="meta")
    run = _run(monkeypatch, _steps({"fit.render": 8e5}),
               profiled_work=[{"grid": grid}])
    assert _reader("adam_roofline_pct")(run) is None


def test_28_bytes_a_voxel_is_what_adam_reads_and_writes():
    """One step of torch's Adam, as fit_grid makes it, then the clamp:
    it keeps two float32 moments of the grid's size beside its step count,
    reads the grid, the gradient and both moments, and writes the grid and
    both moments, leaving the gradient: 4 words read, 3 written."""
    torch.manual_seed(0)
    grid = torch.rand(5, 6, 7).requires_grad_(True)
    opt = torch.optim.Adam([grid], lr=0.05)
    grid.grad = torch.randn_like(grid)
    opt.step()
    state = opt.state[grid]
    moments = [v for v in state.values()
               if torch.is_tensor(v) and v.shape == grid.shape]
    assert len(moments) == 2 and all(m.dtype == torch.float32
                                     for m in moments)
    grid.grad = torch.randn_like(grid)
    before = [t.detach().clone() for t in [grid, grid.grad] + moments]
    opt.step()
    with torch.no_grad():
        grid.clamp_(0.0, 1.0)
    after = [grid.detach(), grid.grad] + moments
    written = [not torch.equal(b, a) for b, a in zip(before, after)]
    assert written == [True, False, True, True]  # the gradient: read only
    words_read = 2 + len(moments)  # the grid, the gradient, the moments
    words_written = 1 + len(moments)
    assert (optimizer_roofline.WORDS_READ,
            optimizer_roofline.WORDS_WRITTEN) == (words_read, words_written)
    assert optimizer_roofline.BYTES_PER_VOXEL == 28
    assert optimizer_roofline.least_s(10 ** 9) == \
        pytest.approx(28e9 / roofline.PEAK_BYTES)
