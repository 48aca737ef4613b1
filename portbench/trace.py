"""The traced sub-window: ``torch.profiler`` over a few units of work, and what
the harness and the per-layer readers take from it.

The profiler records the host's ops and the device's (CUPTI); the span is
the harness's own ``portbench.profiled`` annotation, which ends after a
synchronize, so it holds all the device work it launched.  Nothing here
falls back to another clock: a trace with no device op gives no number.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN = "portbench.profiled"
#: the harness's annotation of a unit of work; a gap is labelled by the one
#: it falls in, or ``outside``
STEP = "portbench.step"
_OWN = (SPAN, STEP)


def capture(fn, n: int, sync) -> dict:
    """Profile ``n`` calls of ``fn(i)``, each under ``portbench.step``, then
    ``sync()``, all under ``portbench.profiled``.  Returns the record the
    readers take: the span, the device ops and the host ops, in µs, and
    ``units``, the calls profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            for i in range(n):
                with record_function(STEP):
                    fn(i)
            sync()
    span, device, host = None, [], []
    for e in prof.events():
        t = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append((e.name, *t))
        elif e.name == SPAN:
            span = t
        else:
            host.append((e.name, *t))
    return {"span": span, "device": device, "host": host, "units": n}


def busy_intervals(rec: dict) -> list[tuple[float, float]]:
    """The union of the device ops' intervals inside the span, merged."""
    s0, s1 = rec["span"]
    ivs = sorted((max(a, s0), min(b, s1)) for _, a, b in rec["device"] if b > s0 and a < s1)
    out = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_and_window_s(rec: dict | None) -> tuple[float, float] | None:
    """``(busy_s, window_s)`` of the traced span; None without device ops."""
    if not rec or rec["span"] is None:
        return None
    busy = busy_intervals(rec)
    if not busy:
        return None
    s0, s1 = rec["span"]
    return sum(b - a for a, b in busy) / 1e6, (s1 - s0) / 1e6


def window_idle_percent(rec: dict, unit: str) -> float | None:
    """100 × one minus the device's busy share of the untraced window: the
    traced span's device-busy seconds a unit of work, times the window's
    ``rec["counts"][unit]`` units, over the window's seconds.  The device's
    time a unit is the profiler's; the window is not profiled, so the
    profiler's own host cost between ops does not count as idle."""
    prof = rec.get("profile")
    bw = busy_and_window_s(prof)
    c = rec["counts"]
    if bw is None or not c.get(unit) or not prof.get("units"):
        return None
    return 100.0 * (1.0 - bw[0] / prof["units"] * c[unit] / c["window_s"])


def _label(own: list, host: list, starts: list, t: float) -> str:
    """What the host was doing at ``t``: the harness's annotation it falls
    in (``own``: its intervals) and the innermost op, not a CUDA runtime
    call, that covers it (looked for among the 400 host ops begun last)."""
    where = next((name.split(".", 1)[1] for name, a, b in own if a <= t <= b), "outside")
    inner = ""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        name, a, b = host[j]
        if b >= t and not name.startswith("cuda"):
            inner = name
            break
    return f"{where}/{inner or 'python'}"


def breakdown(rec: dict | None, top: int = 10) -> dict | None:
    """The contract's ``breakdown``: the device ops that took most time (by
    name, seconds summed) and the idle gaps summed by what the host was
    doing, ``top`` of each."""
    if busy_and_window_s(rec) is None:
        return None
    ops = defaultdict(float)
    for name, a, b in rec["device"]:
        ops[name[:120]] += (b - a) / 1e6
    own = [h for h in rec["host"] if h[0] in _OWN]
    host = sorted((h for h in rec["host"] if h[0] not in _OWN), key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = defaultdict(float)
    s0, s1 = rec["span"]
    edge = s0
    for a, b in busy_intervals(rec) + [(s1, s1)]:
        if a > edge:
            gaps[_label(own, host, starts, (edge + a) / 2)] += (a - edge) / 1e6
        edge = max(edge, b)

    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": best(ops), "idle_gaps": best(gaps)}
