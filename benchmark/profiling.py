"""The device's busy time, its kernels by name and its idle gaps, from
torch.profiler over a bounded stretch of a run's window.

The busy/idle and by-kernel arithmetic is a copy, taken at commit 38e9ffd,
of volumetricrenderer_tpu_torch/tools/trace_flagship.py profile_steps
(device events summed by name), with the busy time taken as the union of
the device's intervals and the idle gaps added. No trace file is written.

A stretch is bracketed by synchronizations and by a host event named
"bench.stretch", whose interval is the stretch on the profiler's clock.
The idle gaps are the parts of that interval in which no device operation
ran; each is named by the innermost host operation under way at its
midpoint (the benchmark's own "bench.*" spans among them), or "python"
where no operation was under way.
"""
from __future__ import annotations

import collections

import torch

TOP = 10  # entries of each list in the breakdown
STRETCH = "bench.stretch"
PROFILER_OWN = ("Activity Buffer Request",)  # the profiler's host events


class Stretch:
    """Profile what runs between start() and stop()."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self._mark = None
        self.summary = None

    def warm(self):
        """Start and stop the profiler once, outside any window: its first
        start sets the device's tracing up, which takes seconds."""
        self.start()
        self.stop()
        self.prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark = torch.profiler.record_function(STRETCH)
        self._mark.__enter__()

    def stop(self):
        """End the stretch; its events are read later, by finish()."""
        self._sync()
        self._mark.__exit__(None, None, None)
        self.prof.stop()
        self._mark = None

    @property
    def running(self):
        return self._mark is not None

    def finish(self):
        """The stretch's summary (summarize), or None if none ran."""
        if self.prof is None:
            return None
        if self.running:
            self.stop()
        self.summary = summarize(self.prof.events())
        self.prof = None
        return self.summary


def _union(intervals, lo, hi):
    """Merged [start, end) intervals clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_labels(cpu, points):
    """For each time point (sorted), the innermost host event under way:
    per-thread stacks of properly nested intervals, swept in order."""
    labels, stacks, i = [], collections.defaultdict(list), 0
    for p in points:
        while i < len(cpu) and cpu[i][0] <= p:
            s, e, name, thread = cpu[i]
            st = stacks[thread]
            while st and st[-1][1] < s:
                st.pop()
            st.append((s, e, name))
            i += 1
        best = None
        for st in stacks.values():
            while st and st[-1][1] < p:
                st.pop()
            if st and (best is None or st[-1][0] > best[0]):
                best = st[-1]
        labels.append(best[2] if best is not None else "python")
    return labels


def summarize(events) -> dict:
    """busy_s and window_s of the stretch, device seconds by name, the
    top device operations and the idle gaps by host label."""
    from torch.autograd import DeviceType
    marks = [e for e in events if e.name == STRETCH
             and e.device_type == DeviceType.CPU]
    if not marks:
        raise RuntimeError("profiler trace holds no stretch mark")
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    # A host annotation (record_function, the optimizer's step) also
    # shows on the device's timeline; it is no device operation.
    notes = {e.name for e in events if getattr(e, "is_user_annotation", False)
             or (e.device_type == DeviceType.CPU and e.name.startswith(
                 ("bench.", "Optimizer.")))}
    dev, cpu = [], []
    by_name = collections.defaultdict(float)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in notes or getattr(e, "is_user_annotation", False):
                continue
            dev.append((s, t))
            by_name[e.name] += (t - s) * 1e-6
        elif e.name != STRETCH and e.name not in PROFILER_OWN:
            cpu.append((s, t, e.name, e.thread))
    busy = _union(dev, lo, hi)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] + g[1])
    cpu.sort()
    labels = _host_labels(cpu, [(g0 + g1) / 2 for g0, g1 in gaps])
    idle = collections.defaultdict(float)
    for (g0, g1), label in zip(gaps, labels):
        idle[label] += (g1 - g0) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_s,
        "window_s": (hi - lo) * 1e-6,
        "device_s_by_name": dict(by_name),
        "device_ops": [[n[:160], s] for n, s in top[:TOP]],
        "idle_gaps": [[n[:160], s] for n, s in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }
