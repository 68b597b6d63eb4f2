"""warp_ms.train (ms, program span): the warp and its splat per fit step:
the device intervals of the program's "warp.fwd" (ops/sweep.finish_image:
the stack, the gather, the per-pixel finish) and "warp.splat"
(_WarpBilinear.backward), summed per "fit.step" and averaged over the
steps of a traced run's profiled stretch."""
from benchmark import program_spans


def read(run):
    return program_spans.per_step_ms(run, ("warp.fwd", "warp.splat"),
                                     device=True)
