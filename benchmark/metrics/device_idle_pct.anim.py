"""The device's idle share of a traced run's profiled stretch, in %:
100 * (1 - busy / stretch), busy the union of the device operations'
intervals (profiling.py)."""


def read(run):
    prof = run.get("profile")
    if not prof or prof["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
