"""The port's spans (volumetricrenderer_tpu_torch/utils/clock.py): an
inactive span records nothing and costs under a microsecond; active spans
nest, carry parent and request ids, are recorded whole or not at all,
take the open root as parent on another thread, and agree with the
profiler's "vr." events; fit_grid (its render, backward, NaN guard,
update and syncs), render_image, plan_sweep, light_transmittance_volume
and the 4-channel sweep give their spans. The file imports no JAX; its
card test runs with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_trace.py
"""
import collections
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import volumetricrenderer_tpu_torch as T
from volumetricrenderer_tpu_torch.fit import fit_grid
from volumetricrenderer_tpu_torch.ops.lighting import \
    light_transmittance_volume
from volumetricrenderer_tpu_torch.ops.sweep import plan_sweep
from volumetricrenderer_tpu_torch.utils import clock

SIZE, W, H = 16, 24, 16
CFG = T.RenderConfig(emission=True, quadrature="sliced")
MED = T.MediumConfig(combine="single", density=8.0)
# Every span a fit step records under its request id, and the spans of
# fit_grid's own (the step's children, and the guard inside the first sync).
FIT_SPANS = ("fit.render", "fit.backward", "fit.guard", "fit.adam",
             "fit.sync", "fit.sync", "warp.fwd", "warp.splat")
STEP_SPANS = ("fit.render", "fit.backward", "fit.sync", "fit.adam",
              "fit.sync")
DEVICE_SPANS = ("fit.render", "fit.backward", "fit.guard", "fit.adam",
                "warp.fwd", "warp.splat")


@pytest.fixture(autouse=True)
def no_spans():
    clock.clear_spans()
    yield
    clock.clear_spans()


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def _spin(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_inactive_spans_record_nothing(monkeypatch):
    def forbidden(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    assert clock.span("a") is clock.span("b", device=torch.ones(1)) \
        is clock.root("r", request=3)
    with clock.root("r", request=1):
        with clock.span("a", device=torch.ones(1)):
            with clock.span("b"):
                pass
    assert clock.spans() == []


def test_inactive_span_costs_under_a_microsecond():
    # A fit step's spans, nested as fit_grid nests them, the tensor of a
    # device interval passed as it passes it; the least of up to five
    # loops: other test workers share the cores.
    x = torch.ones(1)
    n, best = 10 ** 6 // 6, float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with clock.span("fit.render", device=x):
                pass
            with clock.span("fit.backward", device=x):
                pass
            with clock.span("fit.sync"):
                with clock.span("fit.guard", device=x):
                    pass
            with clock.span("fit.adam", device=x):
                pass
            with clock.span("fit.sync"):
                pass
        best = min(best, (time.perf_counter() - t0) / (6 * n))
        if best <= 1e-6:
            break
    assert best <= 1e-6, f"{best * 1e9:.0f} ns per inactive span"
    assert clock.spans() == []


def test_active_spans_nest_with_parent_and_request_ids():
    x = torch.ones(4)
    with clock.tracing():
        with clock.root("r", request=7):
            with clock.span("a", device=x):
                with clock.span("b"):
                    pass
            with clock.span("c"):
                pass
        with clock.root("frame"):
            with clock.span("d"):
                pass
        with clock.span("loose"):
            pass
    with clock.span("after"):
        pass
    s = {sp.name: sp for sp in clock.spans()}
    assert set(s) == {"r", "a", "b", "c", "frame", "d", "loose"}
    assert s["r"].parent is None and s["r"].request == 7
    assert s["a"].parent == s["r"].id and s["c"].parent == s["r"].id
    assert s["b"].parent == s["a"].id
    assert {s[n].request for n in "abc"} == {7}
    assert s["frame"].request == s["frame"].id and \
        s["d"].request == s["frame"].id and s["d"].parent == s["frame"].id
    assert s["loose"].parent is None and s["loose"].request is None
    for name in "abc":
        assert s["r"].t0_ns <= s[name].t0_ns <= s[name].t1_ns <= s["r"].t1_ns
    assert s["a"].device_ns == s["a"].t1_ns - s["a"].t0_ns  # CPU: host
    assert s["b"].device_ns is None
    assert len({sp.id for sp in s.values()}) == len(s)
    assert [sp.name for sp in clock.spans()][:2] == ["b", "a"]  # by end
    assert len(clock.spans()) == 7  # read, not cleared
    clock.clear_spans()
    assert clock.spans() == []


def test_records_are_bounded(monkeypatch):
    assert clock._records.maxlen == clock.MAX_SPANS == 100_000
    monkeypatch.setattr(clock, "_records", collections.deque(maxlen=3))
    with clock.tracing():
        for i in range(5):
            with clock.span(f"s{i}"):
                pass
    assert [s.name for s in clock.spans()] == ["s2", "s3", "s4"]


def test_whole_or_nothing_when_the_profiler_starts_or_stops():
    prof = profile(activities=[ProfilerActivity.CPU])
    with clock.span("before"):  # inactive at its entry
        prof.start()
        with clock.span("inside"):
            pass
    with clock.span("stopped"):  # active at its entry
        _spin(2e-4)
        prof.stop()
        _spin(2e-4)
        with clock.span("late"):  # inactive at its entry
            pass
    s = {sp.name: sp for sp in clock.spans()}
    assert set(s) == {"inside", "stopped"}
    assert s["inside"].parent is None
    assert s["stopped"].t1_ns - s["stopped"].t0_ns >= 4e5
    names = {e.name for e in prof.events()}
    assert "vr.inside" in names and "vr.before" not in names


class _Mark(torch.autograd.Function):
    """Identity whose backward opens a span."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        with clock.span("node", device=g):
            return g * 1.0


def test_span_on_another_thread_takes_the_open_root():
    x = torch.ones(3, requires_grad=True)
    with clock.tracing():
        with clock.root("step", request=4):
            with clock.span("forward"):
                y = _Mark.apply(x).sum()
            worker = threading.Thread(target=y.backward)
            worker.start()
            worker.join(timeout=60)
            assert not worker.is_alive()
    s = {sp.name: sp for sp in clock.spans()}
    assert s["node"].parent == s["step"].id and s["node"].request == 4
    assert s["node"].thread != s["step"].thread
    assert s["forward"].parent == s["step"].id
    assert x.grad is not None


def test_spans_agree_with_the_profilers_events():
    a = torch.rand(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with clock.root("outer", request=0):
            for i in range(4):
                with clock.span(f"work{i}", device=a):
                    for _ in range(5 * (i + 1)):
                        a = (a @ a).clamp_(0.0, 1.0)
                    _spin(1e-3 * i)
    events = {e.name: e for e in prof.events() if e.name.startswith("vr.")}
    spans = clock.spans()
    assert {"vr." + s.name for s in spans} == set(events)
    for s in spans:
        ev = events["vr." + s.name].time_range.elapsed_us() * 1e3
        ns = s.t1_ns - s.t0_ns
        assert abs(ns - ev) <= max(0.05 * ev, 5e4), (s.name, ns, ev)
        assert getattr(events["vr." + s.name], "is_user_annotation", True)


def _camera():
    return T.make_camera(T.CameraConfig(width=W, height=H))


def test_fit_grid_spans_each_step():
    torch.manual_seed(0)
    target = torch.rand(H, W, 3)
    with clock.tracing():
        fit_grid(target, _camera(), CFG, MED, T.LightConfig(),
                 grid_size=SIZE, steps=3, device="cpu")
    spans = clock.spans()
    steps = [s for s in spans if s.name == "fit.step"]
    assert [s.request for s in steps] == [0, 1, 2]
    for step in steps:
        mine = [s for s in spans if s.request == step.request
                and s is not step]
        assert sorted(s.name for s in mine) == sorted(FIT_SPANS)
        assert sorted(s.name for s in spans if s.parent == step.id) == \
            sorted(STEP_SPANS)
        by = _by_name(mine)
        first_sync = min(by["fit.sync"], key=lambda s: s.t0_ns)
        (guard,) = by["fit.guard"]
        assert guard.parent == first_sync.id
        assert first_sync.t0_ns <= guard.t0_ns <= guard.t1_ns \
            <= first_sync.t1_ns
        assert by["warp.fwd"][0].parent == by["fit.render"][0].id
        # On the CPU autograd runs the backward on the calling thread.
        assert by["warp.splat"][0].parent == by["fit.backward"][0].id
        order = sorted(by["fit.render"] + by["fit.backward"]
                       + by["fit.sync"] + by["fit.adam"],
                       key=lambda s: s.t0_ns)
        assert [s.name for s in order] == ["fit.render", "fit.backward",
                                           "fit.sync", "fit.adam",
                                           "fit.sync"]
        for s in mine:
            assert step.t0_ns <= s.t0_ns <= s.t1_ns <= step.t1_ns
    for s in spans:
        if s.name in DEVICE_SPANS:
            assert s.device_ns == s.t1_ns - s.t0_ns > 0
        elif s.name in ("fit.sync", "fit.step"):
            assert s.device_ns is None
    # The call's plan, outside every step.
    assert {s.name for s in spans if s.parent is None} == {
        "fit.step", "plan.build"}


def _reader(metric):
    """The benchmark's reader of `metric` (benchmark/metrics/)."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import harness
    return harness.load_module(
        os.path.join(harness.BENCH, "metrics", metric + ".py"),
        "bench_metric_" + metric.replace(".", "_")).read


@pytest.mark.parametrize("nan_guard", [True, False])
def test_fit_wait_reads_the_syncs_alone(nan_guard):
    """fit_wait_ms is the host time of the fit.sync spans per step; the
    guard nested in the first one adds nothing to it, and the guard and
    the other device spans are read per step by their own names."""
    torch.manual_seed(0)
    target = torch.rand(H, W, 3)
    t0 = time.perf_counter()
    with clock.tracing():
        fit_grid(target, _camera(), CFG, MED, T.LightConfig(),
                 grid_size=SIZE, steps=3, device="cpu", nan_guard=nan_guard)
    run = {"t0": t0, "window_s": time.perf_counter() - t0 + 1.0}
    by = _by_name(clock.spans())
    assert len(by["fit.sync"]) == (6 if nan_guard else 3)
    assert len(by.get("fit.guard", [])) == (3 if nan_guard else 0)
    want = sum(s.t1_ns - s.t0_ns for s in by["fit.sync"]) * 1e-6 / 3
    assert _reader("fit_wait_ms")(run) == pytest.approx(want, rel=1e-12)
    want = sum(s.device_ns for s in by["fit.adam"]) * 1e-6 / 3
    assert _reader("adam_ms")(run) == pytest.approx(want, rel=1e-12)


def test_render_plan_and_light_give_their_spans():
    grid = T.cloud_volume(SIZE, 3, device="cpu")
    light = T.LightConfig(shadow_steps=8)
    with clock.tracing():
        T.render_image(grid, _camera(), CFG, MED, light)
    s = _by_name(clock.spans())
    (frame,) = s["render.image"]
    assert frame.parent is None and frame.request == frame.id
    for name in ("light.sweep", "plan.build", "warp.fwd"):
        (sp,) = s[name]
        assert sp.parent == frame.id and sp.request == frame.id
    (geom,) = s["plan.geometry"]
    assert geom.parent == s["plan.build"][0].id
    assert geom.t1_ns - geom.t0_ns <= \
        s["plan.build"][0].t1_ns - s["plan.build"][0].t0_ns

    clock.clear_spans()
    with clock.tracing():
        plan_sweep(_camera(), grid.shape, CFG, device="cpu")
        light_transmittance_volume(grid, light, CFG, MED)
    s = _by_name(clock.spans())
    assert sorted(s) == ["light.sweep", "plan.build", "plan.geometry"]
    assert all(sp.request is None for v in s.values() for sp in v)
    assert s["plan.geometry"][0].parent == s["plan.build"][0].id
    assert s["light.sweep"][0].parent is None


def _four_channel_frame(backward):
    """A traced absorption frame of a (SIZE,)*3 x 4 grid through the
    4-channel sweep, with a scroll; with `backward`, its sum(rgb^2)
    differentiated to the grid, outside the frame."""
    g = torch.rand(SIZE, SIZE, SIZE, 4,
                   generator=torch.Generator().manual_seed(0))
    g.requires_grad_(backward)
    cfg = T.RenderConfig(quadrature="sliced")
    scroll = torch.linspace(-0.2, 0.3, 12).reshape(4, 3)
    with clock.tracing():
        img = T.render_image(g, _camera(), cfg, T.MediumConfig(),
                             scroll=scroll)
        if backward:
            (img[..., :3] ** 2).sum().backward()
    return _by_name(clock.spans())


def test_four_channel_sweep_gives_its_spans():
    """sweep.ref_layers (the channel-layer build, with its device interval),
    sweep.ref_fwd in the frame and sweep.ref_bwd in its backward; no span
    of the single-channel kernels."""
    s = _four_channel_frame(backward=True)
    (frame,) = s["render.image"]
    (layers,) = s["sweep.ref_layers"]
    (fwd,) = s["sweep.ref_fwd"]
    (bwd,) = s["sweep.ref_bwd"]
    for sp in (layers, fwd):
        assert sp.parent == frame.id and sp.request == frame.id
        assert frame.t0_ns <= sp.t0_ns <= sp.t1_ns <= frame.t1_ns
    assert layers.t1_ns <= fwd.t0_ns
    assert layers.device_ns == layers.t1_ns - layers.t0_ns > 0  # CPU: host
    assert fwd.device_ns is None and bwd.device_ns is None
    assert bwd.parent is None and bwd.t0_ns >= frame.t1_ns
    assert not {"sweep.fwd", "sweep.bwd", "light.sweep"} & set(s)


def test_ref_layers_reads_the_layer_spans_per_frame():
    """ref_layers_ms is the device interval of sweep.ref_layers per
    render.image root; a run whose program records no such span reads
    None."""
    t0 = time.perf_counter()
    s = _four_channel_frame(backward=False)
    run = {"t0": t0, "window_s": time.perf_counter() - t0 + 1.0}
    (layers,) = s["sweep.ref_layers"]
    assert _reader("ref_layers_ms")(run) == pytest.approx(
        layers.device_ns * 1e-6, rel=1e-12)
    clock.clear_spans()
    with clock.tracing():
        T.render_image(T.cloud_volume(SIZE, 3, device="cpu"), _camera(), CFG,
                       MED)
    assert _reader("ref_layers_ms")(run) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the sweep kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_fit_step_spans_on_the_card(cuda):
    torch.manual_seed(0)
    target = torch.rand(H, W, 3, device=cuda)
    with clock.tracing():
        fit_grid(target, _camera(), CFG, MED, T.LightConfig(),
                 grid_size=SIZE, steps=2)
    spans = clock.spans()
    steps = [s for s in spans if s.name == "fit.step"]
    assert len(steps) == 2
    for step in steps:
        mine = [s for s in spans if s.request == step.request
                and s is not step]
        assert sorted(s.name for s in mine) == sorted(
            FIT_SPANS + ("sweep.fwd", "sweep.bwd"))
        by = _by_name(mine)
        for s in mine:
            if s.name in DEVICE_SPANS:
                assert 0 < s.device_ns
        first_sync = min(by["fit.sync"], key=lambda s: s.t0_ns)
        assert by["fit.guard"][0].parent == first_sync.id
        assert by["sweep.fwd"][0].parent == by["fit.render"][0].id
        # Autograd runs CUDA backward nodes on a thread of its own, whose
        # spans take the open root as parent.
        for name in ("warp.splat", "sweep.bwd"):
            (s,) = by[name]
            assert s.thread != step.thread and s.parent == step.id
