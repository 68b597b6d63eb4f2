"""plan_ms (ms, program span): the benchmark's own span around the
program's render.plan_for, synchronized on both sides, the mean per frame
over a traced run's frames outside the profiled stretch."""


def read(run):
    spans = run["spans"].get("plan")
    return 1e3 * sum(spans) / len(spans) if spans else None
