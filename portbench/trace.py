"""The profiler arithmetic of a traced run: device time by kernel name, the
union of kernel intervals (the device's busy time), and the idle gaps
labelled by what the host was doing (the benchmark's own spans, recorded as
``torch.profiler.record_function`` ranges).  The method of the kernel
counts of ``chip_smoke.py`` (kernels by name from ``torch.profiler``),
kept here so that the yardstick lives with the benchmark.
"""

from __future__ import annotations

import contextlib
import time

class Tracer:
    """A profiled stretch of a run; ``span(name)`` marks what the host does."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        """Start the profiler (its start-up takes seconds: call it before the
        window opens) and the traced stretch."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.prof is None or self.t1 is not None:
            yield
            return
        import torch

        with torch.profiler.record_function(f"portbench.{name}"):
            yield

    def summary(self) -> dict:
        """``kernels``: [(name, start_us, end_us)] of the device's kernels
        (not the spans' own annotations on the device's timeline);
        ``spans``: [(name, start_us, end_us)] on the host; ``window_s``: the
        traced stretch on the host's clock."""
        from torch.autograd import DeviceType

        kernels, spans = [], []
        for ev in self.prof.events():
            tr = ev.time_range
            mine = ev.name.startswith("portbench.")
            if mine and ev.device_type != DeviceType.CUDA:
                spans.append((ev.name[len("portbench."):], tr.start, tr.end))
            elif (ev.device_type == DeviceType.CUDA and not mine
                  and not getattr(ev, "is_user_annotation", False)):
                kernels.append((ev.name, tr.start, tr.end))
        return dict(kernels=kernels, spans=spans, window_s=self.t1 - self.t0)


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(kernels: list) -> float:
    return sum(b - a for a, b in merged([(s, e) for _, s, e in kernels])) / 1e6


def seconds_by_name(kernels: list, match=None) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, s, e in kernels:
        if match is None or match(name):
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def idle_gaps(summary: dict, top: int = 10) -> list[list]:
    """The ``top`` longest gaps between busy stretches, each named by the
    benchmark's span (``pack``, ``draw``, ``walk``, ``load``, ``step``)
    that covers most of it, ``other`` where none does."""
    busy = merged([(s, e) for _, s, e in summary["kernels"]])
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:]) if a1 > b0]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        best, cover = "other", 0.0
        for name, s, e in summary["spans"]:
            c = min(b, e) - max(a, s)
            if c > cover:
                best, cover = name, c
        out.append([best, (b - a) / 1e6])
    return out


def breakdown(summary: dict, top: int = 10) -> dict:
    by_name = seconds_by_name(summary["kernels"])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:160], sec] for name, sec in ops],
            "idle_gaps": idle_gaps(summary, top)}
