"""The parts of a fit step as the program's spans record them, for the
per-layer metrics that read one span each: the device interval of spans
of one name per "fit.step" of a traced run's profiled stretch
(program_spans.py). A program that records no span of that name (one
older than the span) gives None, where program_spans.per_step_ms would
read an absent part as 0."""
from benchmark import program_spans


def per_step_device_ms(run, name):
    """The mean device interval, in ms, of the spans named `name` per
    recorded "fit.step", or None where no such span lies in the window."""
    if not any(s.name == name for s in program_spans.in_window(run)):
        return None
    return program_spans.per_step_ms(run, (name,), device=True)
