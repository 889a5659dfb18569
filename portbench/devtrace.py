"""The device trace of a traced run: torch.profiler over the window, read
as intervals on one clock.

Only CUDA activity is recorded (the host's own work is known from the
benchmark's spans, stamped with ``time.time_ns``, the clock the profiler
stamps its events with).  From the trace: the union of the kernel, copy
and set intervals (busy seconds), device seconds and launches by kernel
name, and each idle gap labelled with the innermost host span around its
middle.
"""
from __future__ import annotations

import bisect


def start():
    """A running profiler of the card's activity (of the host's, where
    there is no card: the tests, which then read no device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA
                               if torch.cuda.is_available()
                               else ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def _device_events(prof):
    """(name, start ns, end ns) of every device-side event."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            yield e.name(), s, s + e.duration_ns()


def _innermost(spans: list[tuple[str, int, int]]):
    """A lookup from a time to the innermost span holding it (spans of
    one thread nest or follow each other)."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    starts = [s[1] for s in spans]
    parent = [-1] * len(spans)
    stack: list[int] = []
    for i, (_, t0, _) in enumerate(spans):
        while stack and spans[stack[-1]][2] < t0:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)

    def at(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][2] < t:
            i = parent[i]
        return spans[i][0] if i >= 0 else "outside any span"

    return at


def read(prof, t0: int, t1: int, spans, kernel_names) -> dict:
    """Stop ``prof`` and reduce its trace over the window [t0, t1] ns."""
    prof.__exit__(None, None, None)
    intervals, by_name, kernels = [], {}, {k: [0, 0.0] for k in kernel_names}
    for name, s, e in _device_events(prof):
        if name.startswith("ProfilerStep") or e <= t0 or s >= t1:
            continue
        s, e = max(s, t0), min(e, t1)
        intervals.append((s, e))
        key = name if len(name) <= 80 else name[:77] + "..."
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
        for k in kernel_names:
            if k in name:
                kernels[k][0] += 1
                kernels[k][1] += (e - s) / 1e9
    intervals.sort()
    busy, gaps, cursor = 0, [], t0
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < t1:
        gaps.append((cursor, t1))
    at = _innermost(spans)
    idle: dict[str, float] = {}
    for s, e in gaps:
        label = at((s + e) // 2)
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}
