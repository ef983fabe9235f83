"""The traced slice: torch.profiler (CUDA activity: CUPTI) over whole
requests inside the window, reduced to what the readers need.

- device events: every kernel, copy and set on the card, (name, start ns,
  end ns), clipped to the slice;
- host spans: the benchmark's own marks (`Run.span`), (name, start, end)
  on the wall clock in ns, the clock the profiler's events carry;
- the slice's window: from its first host span's start to its last one's
  end; busy_s: the union of the device events inside it; idle gaps: the
  window less that union, each named by the host span its middle falls in;
- breakdown: the ten device operations with the most time, and idle time
  by host span, both in seconds.
"""

from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict

import torch

SPANS = ("voice", "request_start", "await_chunk", "emit", "between_requests")


@dataclasses.dataclass
class Slice:
    records: list
    device: list[tuple[str, int, int]]
    spans: list[tuple[str, int, int]]
    start: int
    end: int
    busy_s: float
    window_s: float
    breakdown: dict
    host_s: float  # the slice's length on the host's clock

    def kernel_s(self, functions: tuple[str, ...]) -> float:
        """Seconds of the device events whose name holds one of these CUDA
        function names as a whole word."""
        pattern = re.compile(r"(?<![\w])(?:" + "|".join(functions) + r")(?=[<(\s]|$)")
        return sum(e - s for n, s, e in self.device if pattern.search(n)) / 1e9


def start(run):
    """The profiler over the card's activity (on the CPU, where tests run a
    slice, the host's: it holds no device event)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = run.device.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
    prof.__enter__()
    prof.t0 = time.perf_counter()
    return prof


def warm(run) -> None:
    """Start and stop the profiler once around a little device work, so
    that the slice does not pay for loading the tracer (set-up of the
    traced run)."""
    prof = start(run)
    torch.ones(1, device=run.device).add_(1)
    run.sync()
    prof.__exit__(None, None, None)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def stop(prof, records: list, spans: list, run) -> Slice:
    run.sync()
    host_s = time.perf_counter() - prof.t0
    prof.__exit__(None, None, None)
    device = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        t = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA and t > s:
            device.append((e.name(), s, t))
    spans = sorted(spans, key=lambda x: x[1])
    if not spans:
        raise RuntimeError("the traced slice holds no host span")
    start, end = spans[0][1], max(t for _, _, t in spans)
    run.trace_outside_s = sum(max(0, min(t, start) - s) + max(0, t - max(s, end))
                              for _, s, t in device) / 1e9
    device = [(n, max(s, start), min(t, end)) for n, s, t in device if t > start and s < end]
    busy = _union([(s, t) for _, s, t in device])
    busy_ns = sum(t - s for s, t in busy)
    gaps, last = [], start
    for s, t in busy + [(end, end)]:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    idle = defaultdict(int)
    for s, t in gaps:
        mid = (s + t) // 2
        owner = next((n for n, a, b in reversed(spans) if a <= mid < b), "untracked")
        idle[owner] += t - s
    by_op = defaultdict(int)
    for n, s, t in device:
        by_op[n] += t - s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    breakdown = {"device_ops": [[n[:200], v / 1e9] for n, v in top],
                 "idle_gaps": [[n, v / 1e9] for n, v in sorted(idle.items(),
                                                              key=lambda kv: -kv[1])[:10]]}
    return Slice(records=list(records), device=device, spans=spans, start=start, end=end,
                 busy_s=busy_ns / 1e9, window_s=(end - start) / 1e9, breakdown=breakdown,
                 host_s=host_s)
