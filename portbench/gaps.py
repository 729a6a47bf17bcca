"""The device's idle time in a traced run, split into host-bound and
device-side time, the host-bound part put down to the spans the host was in.

The busy intervals are the union of the device's events (``trace.merged``),
as ``idle_share.*`` takes them.  A gap between them is host-bound from its
start up to the start of the host's launch call of the first device event
after it (``cudaLaunchKernel``, ``cudaGraphLaunch``, a memcpy: the runtime
call with the event's correlation id), where that call began after the gap
began: until then the host had not asked for the work.  The rest of the gap
is device-side: the work was queued already (a replayed graph's next node,
a kernel launched ahead) or on its way.  A gap whose next event has no
launch call in the trace is device-side.  The stretch starts at the end of
the tracer's first ``cudaDeviceSynchronize`` (its clock's start of the
traced stretch) and lasts the stretch's ``window_s``, so the time before the
first event and after the last counts too (after the last, the host had
asked for nothing more: host-bound), and host-bound and device-side time add
up to the idle time of ``idle_share.*``.

Each host-bound piece goes to the innermost ``tsdiff.*`` span (the
program's, ``tsdiff_tpu_torch/utils/profiling.py``) open at that time, else
to the innermost ``portbench.*`` span (the benchmark's), else to ``other``.
"""

from __future__ import annotations

import bisect
import re

from portbench import trace

#: the runtime calls that put work on the device
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")
_SYNC = "cudaDeviceSynchronize"


def events(prof) -> dict:
    """From a finished ``torch.profiler`` profile: ``device`` [(start_us,
    end_us, correlation id)] of the device's events (not annotations, as
    ``trace.Tracer.summary`` takes them); ``launch`` {correlation id:
    start_us} of the host's runtime calls; ``spans`` [(name, start_us,
    end_us)] of the ``tsdiff.*`` and ``portbench.*`` spans on the host;
    ``start`` the end of the first ``cudaDeviceSynchronize``, or None."""
    from torch.autograd import DeviceType

    device, launch, spans, start = [], {}, [], None
    for ev in prof.events():
        tr, name = ev.time_range, ev.name
        mine = name.startswith(("portbench.", "tsdiff."))
        if ev.device_type == DeviceType.CUDA:
            if not mine and not getattr(ev, "is_user_annotation", False):
                device.append((tr.start, tr.end, ev.id))
        elif mine:
            spans.append((name, tr.start, tr.end))
        elif _LAUNCH.match(name):
            launch.setdefault(ev.id, tr.start)
            if name == _SYNC and start is None:
                start = tr.end
    return dict(device=device, launch=launch, spans=spans, start=start)


def owner(t: float, spans: list) -> str:
    """The innermost ``tsdiff.*`` span open at ``t``, else the innermost
    ``portbench.*`` one, else ``other``."""
    best = {}
    for name, s, e in spans:
        if s <= t < e:
            kind = name.split(".", 1)[0]
            if kind not in best or (s, -e) > best[kind][1:]:
                best[kind] = (name, s, -e)
    for kind in ("tsdiff", "portbench"):
        if kind in best:
            return best[kind][0]
    return "other"


def attribute(a: float, b: float, spans: list, out: dict) -> None:
    """Add the host-bound piece ``[a, b)`` to ``out``, by ``owner``."""
    over = [sp for sp in spans if sp[1] < b and sp[2] > a]
    cuts = sorted({a, b} | {t for _, s, e in over for t in (s, e) if a < t < b})
    for x, y in zip(cuts, cuts[1:]):
        label = owner((x + y) / 2, over)
        out[label] = out.get(label, 0.0) + (y - x)


def split(device: list, launch: dict, spans: list, stretch=None) -> dict:
    """``host`` {span: us} and ``device_us`` of the idle time in
    ``stretch`` (default: from the first device event to the last),
    ``busy_us``, ``stretch_us`` and ``names``, the spans' names."""
    if not device:
        return dict(host={}, device_us=0.0, busy_us=0.0, stretch_us=0.0,
                    names={n for n, _, _ in spans})
    device = sorted(device)
    starts = [s for s, _, _ in device]
    busy = trace.merged([(s, e) for s, e, _ in device])
    w0, w1 = stretch if stretch is not None else (busy[0][0], busy[-1][1])
    busy = [(max(s, w0), min(e, w1)) for s, e in busy if e > w0 and s < w1]
    host: dict[str, float] = {}
    idle = 0.0
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            idle += s - prev
            if s < w1:      # the launch of the event that ends the gap
                i = bisect.bisect_left(starts, s)
                at = launch.get(device[i][2]) if i < len(device) else None
            else:           # after the last event
                at = w1
            if at is not None and at > prev:
                attribute(prev, min(at, s), spans, host)
        prev = max(prev, e)
    return dict(host=host, device_us=idle - sum(host.values()),
                busy_us=sum(e - s for s, e in busy), stretch_us=w1 - w0,
                names={n for n, _, _ in spans})


def of_run(ctx: dict):
    """``split`` of the traced run of ``ctx`` (kept in ``ctx``), None where
    the run was not traced."""
    if "gaps" not in ctx:
        tracer = getattr(ctx["cell"], "tracer", None)
        prof = tracer.prof if tracer is not None else None
        ctx["gaps"] = None
        if ctx.get("trace") and prof is not None:
            ev = events(prof)
            stretch = None
            if ev["start"] is not None:
                stretch = (ev["start"], ev["start"] + 1e6 * ctx["trace"]["window_s"])
            ctx["gaps"] = split(ev["device"], ev["launch"], ev["spans"], stretch)
    return ctx["gaps"]


def host_ms(ctx: dict, prefix: str, per: int):
    """Host-bound idle ms under the spans named ``prefix*``, over ``per``;
    None where the trace holds no such span (a program without them)."""
    g = of_run(ctx)
    if g is None or not per or not any(n.startswith(prefix) for n in g["names"]):
        return None
    return sum(us for n, us in g["host"].items() if n.startswith(prefix)) / 1e3 / per
