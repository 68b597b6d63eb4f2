"""adam_ms (ms, program span): the optimizer per fit step: the device
interval of the program's "fit.adam" (fit_grid's Adam step and clamp),
averaged over the "fit.step"s of a traced run's profiled stretch."""
from benchmark import program_spans


def read(run):
    return program_spans.per_step_ms(run, ("fit.adam",), device=True)
