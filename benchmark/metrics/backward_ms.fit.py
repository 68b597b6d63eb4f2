"""backward_ms.fit (ms, program span): the backward side of a fit step:
the device interval of the program's "fit.backward" (loss.backward(): the
backward sweep kernel, the warp's splat, the gradient's zeroing and
copies), averaged over the "fit.step"s of a traced run's profiled
stretch."""
from benchmark import fit_spans


def read(run):
    return fit_spans.per_step_device_ms(run, "fit.backward")
