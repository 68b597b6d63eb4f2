"""Timing (port of volumetricrenderer_tpu/utils/clock.py): the host `Clock`
with elapsed()/stamp(), `sync` in place of jax.block_until_ready, and
`device_timer`, which times a function on the device its result lies on.

PyTorch returns from a CUDA call before the device has finished, so a host
clock without a synchronize measures the enqueue. `sync` waits for the
device a result lies on; `device_timer` brackets the calls with CUDA events
when the result is a CUDA tensor and with the host clock otherwise.
"""
from __future__ import annotations

import time

import torch

__all__ = ["Clock", "sync", "device_timer"]


class Clock:
    """Host clock: elapsed() reads, stamp() reads and restarts."""

    def __init__(self):
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since construction or the last stamp."""
        return time.perf_counter() - self._start

    def stamp(self) -> float:
        """Read elapsed and restart."""
        now = time.perf_counter()
        dt = now - self._start
        self._start = now
        return dt


def _cuda_device(result):
    """The CUDA device of the first CUDA tensor in a result (a tensor or a
    tuple, list or dict of results), or None."""
    if isinstance(result, torch.Tensor):
        return result.device if result.device.type == "cuda" else None
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        for item in result:
            dev = _cuda_device(item)
            if dev is not None:
                return dev
    return None


def sync(result):
    """Wait until the device work behind `result` has finished, and return
    it: a no-op for CPU results."""
    dev = _cuda_device(result)
    if dev is not None:
        torch.cuda.synchronize(dev)
    return result


def device_timer(fn, *args, warmup=1, iters=10, **kwargs):
    """Time fn(*args, **kwargs): returns (result, seconds per call) after
    `warmup` untimed calls (at least one: the first call of a sweep builds
    its kernel). A CUDA result is timed between two CUDA events around the
    `iters` calls, a CPU result on the host clock."""
    result = None
    for _ in range(max(warmup, 1)):
        result = sync(fn(*args, **kwargs))
    dev = _cuda_device(result)
    if dev is None:
        t0 = time.perf_counter()
        for _ in range(iters):
            result = fn(*args, **kwargs)
        return result, (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            result = fn(*args, **kwargs)
        end.record()
        end.synchronize()
    return result, start.elapsed_time(end) * 1e-3 / iters
