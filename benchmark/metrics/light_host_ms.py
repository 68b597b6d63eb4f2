"""light_host_ms (ms, program span): the host time of the program's
"light.sweep" (ops/lighting.light_transmittance_volume), not synchronized:
what the host takes to enqueue the light sweep's loop, the mean per call
over a traced run's profiled frames (one call a frame). Beside light_ms,
the synchronized span around the same call: near it where the loop is
bound by the host."""
from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "light.sweep")
