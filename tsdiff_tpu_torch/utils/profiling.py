"""Tracing of the port: program spans on the profiler's clock, and a
torch.profiler trace context.

``span(name, **ids)`` marks a stretch of host work at a layer's boundary
(the packer, the captured walk, the train step).  With no profiler
recording it costs one check of a flag and returns a shared null context:
no string is formatted and nothing is allocated.  While ``torch.profiler``
records, it opens ``record_function("tsdiff." + name, args)``, ``args``
the ids as ``k=v`` pairs; the span then lies in the same profile as the
kernels, on its one clock, is kept in memory and is written out with the
trace.  A span never waits for the device: it marks host time, and a
reader of the trace puts the device's idle gaps down to the spans the host
was in (``portbench/gaps.py``).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_NULL = contextlib.nullcontext()


def span(name: str, **ids):
    """``record_function("tsdiff." + name)`` while the profiler records,
    else a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    args = ",".join(f"{k}={v}" for k, v in ids.items()) if ids else None
    return torch.profiler.record_function("tsdiff." + name, args)


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


def span_totals(prof, prefix: str) -> dict[str, tuple[float, int]]:
    """``{name: (host seconds, calls)}`` of the spans of ``prof`` (a
    finished profile) whose names start with ``"tsdiff." + prefix``."""
    from torch.autograd import DeviceType

    out: dict[str, tuple[float, int]] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith("tsdiff." + prefix):
            seconds, calls = out.get(ev.name, (0.0, 0))
            out[ev.name] = (seconds + (ev.time_range.end - ev.time_range.start) / 1e6, calls + 1)
    return out
