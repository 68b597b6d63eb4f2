"""plan_host_ms (ms, program span): the host time of the program's
"plan.geometry" (ops/sweep._host_geometry, the plan's float64 numpy
geometry), the mean per plan over a traced run's profiled frames (one
plan a frame). At most plan_ms, the synchronized span around the whole
plan; the rest of the plan is its copies to the device and its per-pixel
maps."""
from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "plan.geometry")
