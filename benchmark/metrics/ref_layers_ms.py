"""ref_layers_ms (ms, program span): the device interval of the program's
"sweep.ref_layers" (kernels/sweep_ref_fwd.py sweep_base_ref: the 4-channel
sweep's channel layers, _layer_channels), the mean per recorded
"render.image" root over a traced run's profiled frames. None where the
program records no such span (one older than it)."""
from benchmark import program_spans


def read(run):
    spans = program_spans.in_window(run)
    frames = {s.request for s in spans if s.name == "render.image"}
    values = [s.device_ns for s in spans
              if s.name == "sweep.ref_layers" and s.request in frames]
    if not frames or not values or None in values:
        return None
    return 1e-6 * sum(values) / len(frames)
