"""The program's own spans (volumetricrenderer_tpu_torch/utils/clock.py)
that a traced run recorded inside its window, for the per-layer metrics
that read them (source "program_span").

The program records a span only while a profiler runs, so in a traced run
these are the profiled stretch's spans: the fit's 10 steps, the frames'
profiled frames. A program without spans (no clock.spans) gives none, and
each reader then returns None.
"""


def in_window(run):
    """The spans that began and ended inside the run's window."""
    from volumetricrenderer_tpu_torch.utils import clock
    read = getattr(clock, "spans", None)
    if read is None:
        return []
    lo = run["t0"] * 1e9
    hi = (run["t0"] + run["window_s"]) * 1e9
    return [s for s in read() if lo <= s.t0_ns and s.t1_ns <= hi]


def per_step_ms(run, names, device):
    """The mean per recorded "fit.step" root, in ms, of the spans named in
    `names` under it (same request id): their device intervals where
    `device`, else their host intervals. None where no step was recorded,
    or where such a span has no device interval to read."""
    spans = in_window(run)
    steps = {s.request for s in spans if s.name == "fit.step"}
    values = [s.device_ns if device else s.t1_ns - s.t0_ns
              for s in spans if s.name in names and s.request in steps]
    if not steps or None in values:
        return None
    return 1e-6 * sum(values) / len(steps)


def per_call_ms(run, name):
    """The mean host interval, in ms, of the spans named `name`, or None
    where none was recorded."""
    host = [s.t1_ns - s.t0_ns for s in in_window(run) if s.name == name]
    return 1e-6 * sum(host) / len(host) if host else None
