"""Reduce a profiler trace of a stretch of the window to the numbers the
per-layer metrics and the ``breakdown`` read.

Busy time is the union of the intervals in which any operation ran on the
device (kernels, copies, sets), clipped to the stretch. The stretch's time
is its wall time, on the profiler's own clock, less the idle time in which
the profiler itself held the host (its buffer flushes and requests,
``PROFILER_EVENTS``): the program does not pay that without the
profiler. Idle time is the rest. An idle gap is named by the innermost
host event that spans its middle, under the harness's span around it
(``bench.*``).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

SPAN_PREFIX = "bench."
PROFILER_EVENTS = ("Buffer Flush", "Activity Buffer Request")
NAMED_GAPS = 256     # the longest gaps that get a name
TOP = 10


def union(intervals) -> list:
    """Merge (start, end) intervals; returns the disjoint sorted union."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(merged: list, lo: float, hi: float) -> list:
    """The idle (start, end) intervals of [lo, hi] around a merged union."""
    out, cur = [], lo
    for s, e in merged:
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def reduce(device_events, host_events, lo: float, hi: float) -> dict:
    """``device_events`` and ``host_events``: (name, start, end) in seconds
    on one clock; [lo, hi] the stretch. Returns ``busy_s``, ``window_s``
    (the stretch less the profiler's own idle time, ``profiler_s``),
    ``kernels`` {name: (launches, seconds inside the stretch)},
    ``device_ops`` and ``idle_gaps`` (the top entries, [name, seconds])."""
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in device_events if e > lo and s < hi]
    merged = union([(s, e) for _, s, e in dev])
    kernels = defaultdict(lambda: [0, 0.0])
    for n, s, e in dev:
        kernels[n][0] += 1
        kernels[n][1] += e - s
    own = union([(max(s, lo), min(e, hi)) for n, s, e in host_events
                 if n in PROFILER_EVENTS and e > lo and s < hi])
    idle_all = [p for g in gaps(merged, lo, hi) for p in _minus(g, own)]
    profiler_s = sum(e - s for s, e in gaps(merged, lo, hi)) - sum(e - s for s, e in idle_all)
    idle = sorted(idle_all, key=lambda g: g[0] - g[1])[:NAMED_GAPS]
    host = [(n, s, e) for n, s, e in host_events
            if e > lo and s < hi and n not in PROFILER_EVENTS]
    names = np.array([n for n, _, _ in host], dtype=object)
    starts = np.array([s for _, s, _ in host])
    ends = np.array([e for _, _, e in host])
    by_name = defaultdict(float)
    for s, e in idle:
        by_name[_gap_name(names, starts, ends, 0.5 * (s + e))] += e - s
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"busy_s": sum(e - s for s, e in merged), "window_s": hi - lo - profiler_s,
            "profiler_s": profiler_s,
            "kernels": {k: (v[0], v[1]) for k, v in kernels.items()},
            "device_ops": [[k[:160], v[1]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]}


def _minus(gap, merged) -> list:
    """The parts of interval ``gap`` outside the disjoint sorted ``merged``."""
    out, (s, e) = [], gap
    for a, b in merged:
        if b <= s or a >= e:
            continue
        if a > s:
            out.append((s, a))
        s = max(s, b)
    if e > s:
        out.append((s, e))
    return out


def _gap_name(names, starts, ends, t: float) -> str:
    """The innermost harness span and the innermost other host event that
    span time ``t``."""
    idx = np.flatnonzero((starts <= t) & (ends >= t)) if len(names) else []
    spans = [i for i in idx if str(names[i]).startswith(SPAN_PREFIX)]
    ops = [i for i in idx if not str(names[i]).startswith(SPAN_PREFIX)]

    def inner(ids):
        return min(ids, key=lambda i: ends[i] - starts[i])

    head = str(names[inner(spans)]) if spans else "host"
    return f"{head}/{str(names[inner(ops)])[:80]}" if ops else f"{head} (python)"


def from_profiler(prof, span: str) -> dict:
    """``reduce`` over a finished ``torch.profiler.profile``: its device and
    host events, the stretch being the host span named ``span``."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    dev_events, host_events, lo, hi = [], [], None, None
    for ev in results.events():
        s = (ev.start_ns() - base) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            # the device track's copies of host spans are no device work
            if not (ev.is_user_annotation() or ev.name().startswith(SPAN_PREFIX)):
                dev_events.append((ev.name(), s, e))
        else:
            host_events.append((ev.name(), s, e))
            if ev.name() == span:
                lo, hi = s, e
    if lo is None:
        raise RuntimeError(f"the trace holds no span {span!r}")
    return reduce(dev_events, host_events, lo, hi)
