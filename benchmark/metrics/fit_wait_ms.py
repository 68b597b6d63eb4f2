"""fit_wait_ms (ms, program span): how long fit_grid's host waits for the
device per step: the host time of the program's two "fit.sync" spans (the
NaN guard's check and the loss read back), summed per "fit.step" and
averaged over the steps of a traced run's profiled stretch."""
from benchmark import program_spans


def read(run):
    return program_spans.per_step_ms(run, ("fit.sync",), device=False)
