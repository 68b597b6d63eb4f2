"""guard_ms (ms, program span): the NaN guard's device work per fit step:
the device interval of the program's "fit.guard" (the finiteness
reduction over the loss and every voxel's gradient, inside the first
"fit.sync"), averaged over the "fit.step"s of a traced run's profiled
stretch."""
from benchmark import fit_spans


def read(run):
    return fit_spans.per_step_device_ms(run, "fit.guard")
