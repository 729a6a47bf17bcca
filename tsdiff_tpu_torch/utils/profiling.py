"""Tracing and profiling utilities: phase timers that wait for the device,
and a torch.profiler trace context.

A CUDA launch returns before the card finishes, so a phase that ends in
device work is timed up to a ``torch.cuda.synchronize`` of the device its
result lies on (``_force_sync``; nothing to wait for on the CPU).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulating wall-clock timers keyed by phase name."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                _force_sync(sync_value)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:>24}: {tot:8.3f}s total, {tot / n * 1000:8.2f}ms avg ({n}x)")
        return "\n".join(lines)


def _first_tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _force_sync(value) -> None:
    """Wait until the device of the first tensor in ``value`` (a tensor, or
    a dict, list or tuple holding one) has finished its queued work."""
    t = _first_tensor(value)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block, CPU and CUDA activities; writes a
    Chrome trace to ``<log_dir>/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_blocked(fn, *args, **kwargs) -> tuple[float, object]:
    """Run fn, wait for its output's device, return ``(seconds, output)``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _force_sync(out)
    return time.perf_counter() - t0, out
