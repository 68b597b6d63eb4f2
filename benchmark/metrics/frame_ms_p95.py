"""frame_ms_p95 (ms, host clock): the 95th percentile, nearest rank, of
every request's latency in the window, from its camera to its frame in
host memory."""
import math
import sys


def read(run):
    lat = sorted(run.get("latencies_s", []))
    if not lat:
        return None
    print(f"frame_ms_p95: {len(lat)} samples, "
          f"{len(lat) - math.ceil(0.95 * len(lat))} beyond it",
          file=sys.stderr)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
