"""ref_layers_ms.fit (ms, program span): the 4-channel fit's channel
layers per fit step: the device intervals of the program's
"sweep.ref_layers" (kernels/sweep_ref_fwd.py sweep_base_ref: the layer
build) and "sweep.ref_layers_bwd" (its backward), summed per "fit.step"
and averaged over the steps of a traced run's profiled stretch. None where
the program records no "sweep.ref_layers_bwd" (one older than it)."""
from benchmark import fit_spans, program_spans


def read(run):
    if fit_spans.per_step_device_ms(run, "sweep.ref_layers_bwd") is None:
        return None
    return program_spans.per_step_ms(
        run, ("sweep.ref_layers", "sweep.ref_layers_bwd"), device=True)
