"""render_ms.fit (ms, program span): the forward side of a fit step: the
device interval of the program's "fit.render" (fit_grid's forward render,
the forward sweep kernel and the warp, and the loss), averaged over the
"fit.step"s of a traced run's profiled stretch."""
from benchmark import fit_spans


def read(run):
    return fit_spans.per_step_device_ms(run, "fit.render")
