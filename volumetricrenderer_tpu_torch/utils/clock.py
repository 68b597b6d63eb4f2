"""Timing (port of volumetricrenderer_tpu/utils/clock.py): the host `Clock`
with elapsed()/stamp(), `sync` in place of jax.block_until_ready,
`device_timer`, which times a function on the device its result lies on,
and the program's spans.

PyTorch returns from a CUDA call before the device has finished, so a host
clock without a synchronize measures the enqueue. `sync` waits for the
device a result lies on; `device_timer` brackets the calls with CUDA events
when the result is a CUDA tensor and with the host clock otherwise.

Spans (`span`, `root`) mark the program's layers: a fit step and its
optimizer update and syncs, a frame, the sweep kernels' launch wrappers,
the warp and its splat, the plan and the light sweep. A span is active
only while a torch profiler runs or inside a `tracing()` block, which is
decided when it is entered, so a span is recorded whole or not at all.
An inactive span is one shared null context: no clock read, no
allocation. An active span enters `torch.profiler.record_function("vr." +
name)`, so it shows in the profiler's trace beside the operations, and
appends a record (`Span`) to a bounded list in memory that `spans()`
reads and `clear_spans()` empties. Its parent is the innermost open span
on its thread, or, on a thread with none open (autograd runs CUDA
backward nodes on a thread of its own), the innermost open root; a root
opens a request id that every span under it carries. A span given the
tensor its work runs on also has a device interval: on CUDA the time
between two events on the current stream, from the stream reaching the
span's first work to the end of its last; elsewhere its host interval.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Clock", "sync", "device_timer", "Span", "span", "root",
           "tracing", "spans", "clear_spans", "MAX_SPANS"]


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


MAX_SPANS = 100_000  # records kept; the oldest are dropped beyond it


class Span(NamedTuple):
    """One recorded span. Times are time.perf_counter_ns() on the host;
    device_ns is the device interval in ns, or None for a span given no
    tensor."""
    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    thread: int
    t0_ns: int
    t1_ns: int
    device_ns: Optional[float]


_records = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()  # .stack: the thread's open spans
_roots = []  # open roots on every thread, innermost last
_tracing = 0  # open tracing() blocks
_tracing_lock = threading.Lock()


class _Null:
    """The inactive span: one shared instance, entered and left at the
    cost of two method calls."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _Null()


class _Active:
    """An active span: its record_function range, its ids and host clock,
    and with a tensor its device interval."""

    __slots__ = ("name", "device", "is_root", "request", "id", "parent",
                 "thread", "stack", "t0", "rf", "events", "stream")

    def __init__(self, name, device, is_root, request):
        self.name, self.device, self.is_root = name, device, is_root
        self.request = request

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else (_roots[-1] if _roots else None)
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        if self.is_root:
            if self.request is None:
                self.request = self.id
            _roots.append(self)
        else:
            self.request = None if outer is None else outer.request
        self.thread, self.stack = threading.get_ident(), stack
        stack.append(self)
        self.rf = torch.profiler.record_function("vr." + self.name)
        self.rf.__enter__()
        # events: None (no device interval), True (the host interval, for
        # a tensor off CUDA) or a pair of CUDA events on the stream.
        dev, self.events = self.device, None
        if isinstance(dev, torch.Tensor):
            self.events = True
            if dev.is_cuda:
                self.stream = torch.cuda.current_stream(dev.device)
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if isinstance(self.events, tuple):
            self.events[1].record(self.stream)
        self.rf.__exit__(*exc)
        self.stack.remove(self)
        if self.is_root:
            _roots.remove(self)
        _records.append((self.name, self.id, self.parent, self.request,
                         self.thread, self.t0, t1, self.events))
        return False


def span(name: str, device=False):
    """A span named `name` around the block: the null context unless a
    torch profiler runs or a tracing() block is open. `device`: the tensor
    the block's work runs on, for a device interval (False: none)."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Active(name, device, False, None)


def root(name: str, request: Optional[int] = None):
    """A root span: as span(), and it opens request id `request` (its own
    span id where None) for every span under it."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Active(name, False, True, request)


@contextlib.contextmanager
def tracing():
    """Spans are active inside the block, with or without a profiler."""
    global _tracing
    with _tracing_lock:
        _tracing += 1
    try:
        yield
    finally:
        with _tracing_lock:
            _tracing -= 1


def spans():
    """Every span recorded (at most MAX_SPANS, oldest first by end), as
    `Span`s; the list is kept. Reading a CUDA span's device interval waits
    for its end event."""
    out = []
    for name, sid, parent, request, thread, t0, t1, dev in list(_records):
        if dev is True:
            dev = float(t1 - t0)
        elif dev is not None:
            dev[1].synchronize()
            dev = dev[0].elapsed_time(dev[1]) * 1e6
        out.append(Span(name, sid, parent, request, thread, t0, t1, dev))
    return out


def clear_spans():
    """Forget every recorded span."""
    _records.clear()
