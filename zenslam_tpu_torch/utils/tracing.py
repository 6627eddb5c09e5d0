"""Spans, device stamps and counters inside the port, off by default.

Host spans (``span``) mark the layer boundaries of the host's work: the
frame (``process_frame``) and its upload, noise draw, replay, snapshot,
telemetry wait and keyframe back end, the back end's phases, the waits on
device->host copies (``hostio.wait``) and the captures
(``graphs.capture``). Each keeps its name, an optional detail (the copy's
kind, the captured program's name), its ``perf_counter_ns`` start and end,
its parent and the frame it serves, in a preallocated ring. A span whose
``frame`` is not given serves its parent's frame.

Device stamps (``begin``, ``end``, ``stage``) mark where device work
starts and ends. On CUDA a stamp is one one-thread kernel
(``csrc/stamp.cu``) that reads ``%globaltimer`` and writes (stamp id, ns)
into a ring in device memory, allocated once per device and never moved:
the current device's when tracing is first enabled, another's when a
stamp first meets it outside a capture. Launched while a program captures, the
stamp is a node of the graph, its id fixed at the capture, so every replay
stamps the ring with no host work. On the CPU a stamp writes the host
clock into a ring of the same layout, so the CPU tests exercise the ids,
the order and the pairing. Every captured program stamps its first and
last node under its name (``utils/graphs.py``); ``slam_step`` stamps its
stages, each from the previous boundary of its span to the next.

Off (the default), a span is one check that returns a shared null context
and a stamp launches nothing: the captured graphs are what they are
without this module. The switch is part of every capture key
(``utils/graphs.py:_settings``), so a program captured with tracing on is
never replayed with it off, nor the other way.

``reset()`` empties the rings and takes the first point of the clock fit;
``collect()`` takes the second, copies each device ring once and returns
the host spans, the device spans on the host clock, the idle intervals
between device spans and the count of records lost to a wrapped ring
(``dropped``). While ``torch.profiler`` records, each host
span also opens a ``record_function`` of its name, so a profiled run shows
the program's spans on the profiler's clock and the stamp kernels on its
device track.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

HOST_CAPACITY = 1 << 17     # host spans, about 9 a frame: over 60 s at 100 frames/s
STAMP_CAPACITY = 1 << 18    # device stamps a device, about 20 a frame
LAUNCH_CAPACITY = 1 << 17   # program calls, for the frames their device spans serve

BEGIN, END, STAGE, CALIBRATE = 0, 1, 2, 3

_NULL = contextlib.nullcontext()
_ON = False
_MUTED = 0


class _Counters:
    """``stamps``: the stamps the program took (a replay adds its graph's,
    as the hand kernels' launches are counted; 0 while tracing is off)."""

    stamps = 0


counters = _Counters()


class Span(NamedTuple):
    """A host or device span: ``start`` and ``end`` in ns on the host's
    ``perf_counter_ns`` clock; ``parent`` the index of the enclosing span
    in the same list, or -1; ``detail`` the host span's detail, or a
    device span's device."""

    name: str
    start: int
    end: int
    frame: int
    parent: int
    detail: str


class _Names:
    """Strings interned as small ints (the ids the rings hold)."""

    def __init__(self):
        self.ids: dict = {}
        self.names: list = []

    def id(self, name: str) -> int:
        i = self.ids.get(name)
        if i is None:
            i = self.ids[name] = len(self.names)
            self.names.append(name)
        return i


_NAMES = _Names()
_STAMP_IDS: dict = {}      # (name, kind) -> stamp id
_STAMP_KINDS: list = []    # stamp id -> (name, kind)


def _stamp_id(name: str, kind: int) -> int:
    key = (name, kind)
    i = _STAMP_IDS.get(key)
    if i is None:
        i = _STAMP_IDS[key] = len(_STAMP_KINDS)
        _STAMP_KINDS.append(key)
    return i


class _HostRing:
    """The host spans: a record per span, written where it opens and ends."""

    def __init__(self, capacity: int):
        self.mask = capacity - 1
        self.name = np.zeros(capacity, np.int32)
        self.detail = np.zeros(capacity, np.int32)
        self.start = np.zeros(capacity, np.int64)
        self.end = np.zeros(capacity, np.int64)
        self.parent = np.zeros(capacity, np.int64)   # the parent's record number, or -1
        self.frame = np.zeros(capacity, np.int64)
        self.count = 0
        self.stack: list = []     # (record number, frame) of the open spans
        self.epoch = 0            # advanced by reset: spans open across it are dropped

    def reset(self) -> None:
        self.count = 0
        self.stack = []
        self.epoch += 1


class _LaunchLog:
    """(device, program, frame) of each captured program's call, in order:
    the k-th device span of a program on a device serves the k-th call's
    frame."""

    def __init__(self, capacity: int):
        self.mask = capacity - 1
        self.device = np.zeros(capacity, np.int32)
        self.program = np.zeros(capacity, np.int32)
        self.frame = np.zeros(capacity, np.int64)
        self.count = 0


class _DeviceRing:
    """One device's stamps: element 0 the count since the last reset, then
    (stamp id, ns) per slot (``csrc/stamp.cu``'s layout)."""

    def __init__(self, dev: torch.device, capacity: int):
        self.dev, self.capacity = dev, capacity
        self.buf = torch.zeros(2 + 2 * capacity, dtype=torch.int64, device=dev)
        self.cpu = dev.type == "cpu"
        self.host = self.buf.numpy() if self.cpu else None
        self.first = None     # (device ns, host ns, half-bracket ns) at the last reset

    def stamp(self, sid: int) -> None:
        if self.cpu:
            h = self.host
            n = int(h[0])
            h[0] = n + 1
            k = 2 + 2 * (n & (self.capacity - 1))
            h[k] = sid
            h[k + 1] = time.perf_counter_ns()
            return
        from zenslam_tpu_torch.ops import cuda_build

        with torch.cuda.device(self.dev):
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            status = _lib().stamp_launch(self.buf.data_ptr(), self.capacity, sid, stream)
        cuda_build.check(status, "stamp")

    def point(self) -> tuple:
        """A point of the clock fit: (device ns, host ns, half-bracket ns)
        of a stamp taken between two host readings around a synchronise. On
        the CPU the stamp is a host reading itself."""
        if self.cpu:
            t = time.perf_counter_ns()
            return t, t, 0
        torch.cuda.synchronize(self.dev)
        a = time.perf_counter_ns()
        self.stamp(_stamp_id("tracing.clock", CALIBRATE))
        torch.cuda.synchronize(self.dev)
        b = time.perf_counter_ns()
        n = int(self.buf[0].item())
        k = 2 + 2 * ((n - 1) & (self.capacity - 1))
        return int(self.buf[k + 1].item()), (a + b) // 2, (b - a + 1) // 2

    def reset(self) -> None:
        if self.cpu:
            self.host[0] = 0
        else:
            torch.cuda.synchronize(self.dev)
            self.buf[0].zero_()
        self.first = self.point()


class _State:
    def __init__(self):
        self.host = _HostRing(HOST_CAPACITY)
        self.launches = _LaunchLog(LAUNCH_CAPACITY)
        self.rings: dict = {}
        self.window_lo = time.perf_counter_ns()


_STATE: _State | None = None


def _lib():
    from zenslam_tpu_torch.ops import cuda_build

    lib = cuda_build.load("stamp")
    if not getattr(lib, "_typed", False):
        lib.stamp_launch.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_longlong,
                                     ctypes.c_void_p]
        lib.stamp_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def enabled() -> bool:
    """Whether tracing is on (part of every capture key)."""
    return _ON


def enable() -> None:
    """Turn tracing on: the rings are made on the first call (the CPU's,
    and the current CUDA device's with its stamp kernel built), then
    reset."""
    global _ON, _STATE
    if _STATE is None:
        _STATE = _State()
        _STATE.rings[torch.device("cpu")] = _DeviceRing(torch.device("cpu"), STAMP_CAPACITY)
        if torch.cuda.is_available():
            _lib()
            dev = torch.device("cuda", torch.cuda.current_device())
            _STATE.rings[dev] = _DeviceRing(dev, STAMP_CAPACITY)
    _ON = True
    reset()


def disable() -> None:
    """Turn tracing off; the rings stay where they are."""
    global _ON
    _ON = False


def reset() -> None:
    """Empty the rings (after a synchronise) and take the clock fit's first
    point; the window that ``collect`` reads starts here."""
    st = _STATE
    if st is None:
        return
    st.host.reset()
    st.launches.count = 0
    for ring in st.rings.values():
        ring.reset()
    st.window_lo = time.perf_counter_ns()


@contextlib.contextmanager
def muted():
    """No stamp inside the block (a program's warm-up run, which is not a
    call)."""
    global _MUTED
    _MUTED += 1
    try:
        yield
    finally:
        _MUTED -= 1


class _Span:
    __slots__ = ("name", "detail", "frame", "n", "epoch", "rf")

    def __init__(self, name: str, detail: str, frame):
        self.name, self.detail, self.frame = name, detail, frame
        self.rf = None

    def __enter__(self):
        ring = _STATE.host
        parent, pframe = ring.stack[-1] if ring.stack else (-1, -1)
        frame = pframe if self.frame is None else int(self.frame)
        n = self.n = ring.count
        ring.count += 1
        self.epoch = ring.epoch
        k = n & ring.mask
        ring.name[k] = _NAMES.id(self.name)
        ring.detail[k] = _NAMES.id(self.detail)
        ring.parent[k] = parent
        ring.frame[k] = frame
        ring.end[k] = -1
        ring.stack.append((n, frame))
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        ring.start[k] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        ring = _STATE.host
        if self.epoch != ring.epoch:
            return False
        k = self.n & ring.mask
        if ring.count - self.n <= ring.mask:      # not overwritten by a wrapped ring
            ring.end[k] = t
        while ring.stack and ring.stack[-1][0] >= self.n:
            ring.stack.pop()
        return False


def span(name: str, detail: str = "", frame=None):
    """A host span around the ``with`` block (a shared null context while
    tracing is off). ``frame``: the frame the work serves (default: the
    parent's)."""
    if not _ON:
        return _NULL
    return _Span(name, detail, frame)


def _stamp(name: str, device, kind: int) -> None:
    if not _ON or _MUTED:
        return
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ring = _STATE.rings.get(dev)
    if ring is None:
        with torch.cuda.device(dev):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"tracing has no stamp ring on {dev}: its first stamp "
                                   "there is inside a capture")
        ring = _STATE.rings[dev] = _DeviceRing(dev, STAMP_CAPACITY)
        ring.reset()
    ring.stamp(_stamp_id(name, kind))
    counters.stamps += 1


def begin(name: str, device) -> None:
    """Stamp the start of device span ``name`` on ``device``."""
    _stamp(name, device, BEGIN)


def end(name: str, device) -> None:
    """Stamp the end of device span ``name`` (and of its open stage)."""
    _stamp(name, device, END)


def stage(name: str, device) -> None:
    """Stamp a stage boundary inside the innermost open device span: the
    stage open there ends and stage ``name`` starts, from the span's last
    boundary (its start, the end of a span inside it, or this stamp)."""
    _stamp(name, device, STAGE)


def launched(program: str, device) -> None:
    """Log a captured program's call (a replay, or a CPU run) with the
    frame of the innermost open host span."""
    if not _ON or _MUTED:
        return
    st = _STATE
    log = st.launches
    k = log.count & log.mask
    log.device[k] = _NAMES.id(str(torch.device(device)))
    log.program[k] = _NAMES.id(program)
    log.frame[k] = st.host.stack[-1][1] if st.host.stack else -1
    log.count += 1


def fit(first: tuple, second: tuple):
    """The map from device ns to host ns through two points (device ns,
    host ns, half-bracket ns), and its uncertainty in ns (the larger
    half-bracket: between the points the fit interpolates)."""
    d1, h1, e1 = first
    d2, h2, e2 = second
    scale = (h2 - h1) / (d2 - d1) if d2 != d1 else 1.0

    def to_host(d):
        return np.rint(h1 + (np.asarray(d, np.int64) - d1) * scale).astype(np.int64)

    return to_host, max(e1, e2)


def _pair(stamps, to_host, launch_frames: dict, device: str) -> list:
    """Device spans from one ring's stamps, (stamp id, device ns) in the
    order they were taken: a ``BEGIN`` opens a span (a captured program's
    serves the frame of its call, from ``launch_frames`` {program: [frame,
    ...]}; any other its parent's), an ``END`` closes the innermost open
    span of its name with its open stage, a ``STAGE`` closes the stage open
    in the innermost span and opens the next one from that span's last
    boundary; a stage outside every span is dropped."""
    if not len(stamps):
        return []
    ids = np.asarray(stamps)[:, 0]
    times = to_host(np.asarray(stamps)[:, 1])
    spans: list = []
    stack: list = []      # [name, start, frame, index, open stage (name, start) or None, last]
    taken: dict = {}

    def close_stage(top, t):
        if top[4] is not None:
            spans.append(Span(top[4][0], top[4][1], t, top[2], top[3], device))
            top[4] = None

    for sid, t in zip(ids.tolist(), times.tolist()):
        name, kind = _STAMP_KINDS[sid]
        if kind == CALIBRATE:
            continue
        if kind == BEGIN:
            frames = launch_frames.get(name)
            if frames is not None:
                i = taken.get(name, 0)
                taken[name] = i + 1
                frame = frames[i] if i < len(frames) else -1
            else:
                frame = stack[-1][2] if stack else -1
            spans.append(None)
            stack.append([name, t, frame, len(spans) - 1, None, t])
        elif kind == STAGE:
            if stack:
                top = stack[-1]
                start = t if top[4] is not None else top[5]
                close_stage(top, t)
                top[4] = (name, start)
                top[5] = t
        else:
            while stack and stack[-1][0] != name:       # an END lost to a wrapped ring
                stack.pop()
            if not stack:
                continue
            top = stack.pop()
            close_stage(top, t)
            parent = stack[-1][3] if stack else -1
            spans[top[3]] = Span(name, top[1], t, top[2], parent, device)
            if stack:
                stack[-1][5] = t
    keep = [i for i, s in enumerate(spans) if s is not None]
    index = {old: new for new, old in enumerate(keep)}
    return [s._replace(parent=index.get(s.parent, -1)) for s in (spans[i] for i in keep)]


def _union(intervals) -> list:
    """The disjoint sorted union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _idle(device_spans, host_spans, lo: int, hi: int) -> list:
    """The intervals of [lo, hi] in which no device span runs, each named
    by the innermost host span open at its midpoint ("host" outside every
    span; a detail follows its name after a colon)."""
    starts = [s.start for s in host_spans]
    order = sorted(range(len(host_spans)), key=starts.__getitem__)
    sorted_starts = [starts[i] for i in order]
    out, cur = [], lo
    for s, e in _union([(s.start, s.end) for s in device_spans]) + [(hi, hi)]:
        s, e = max(s, lo), min(e, hi)
        if s > cur:
            out.append((cur, s, _innermost(host_spans, order, sorted_starts, (cur + s) // 2)))
        cur = max(cur, e)
        if cur >= hi:
            break
    return out


def _innermost(host_spans, order, sorted_starts, t: int) -> str:
    """The innermost host span open at ``t``: the last one started by then,
    or the nearest of its ancestors still open (host spans nest)."""
    j = bisect.bisect_right(sorted_starts, t) - 1
    i = order[j] if j >= 0 else -1
    while i >= 0 and host_spans[i].end < t:
        i = host_spans[i].parent
    if i < 0:
        return "host"
    s = host_spans[i]
    return f"{s.name}:{s.detail}" if s.detail else s.name


def collect() -> dict:
    """Everything since the last ``reset``: synchronises each device, takes
    the clock fit's second point and copies each ring once. Returns
    ``host`` and ``device`` (lists of ``Span``, each on the host clock in
    ns), ``idle`` ((start, end, name) between device spans over the
    window), ``window_ns`` (reset to collect), ``fit_ns`` (the fit's
    uncertainty, the largest over the rings that gave device spans) and
    ``dropped`` (records lost to a wrapped ring).
    Writes no file."""
    st = _STATE
    if st is None:
        raise RuntimeError("tracing was never enabled")
    hi = time.perf_counter_ns()
    dropped = 0
    host = st.host
    n_host = host.count
    lost = max(0, n_host - (host.mask + 1))
    dropped += lost
    first = lost
    keep = [n for n in range(first, n_host) if host.end[n & host.mask] >= 0]
    number = {n: i for i, n in enumerate(keep)}
    names = _NAMES.names
    host_spans = [Span(names[host.name[k]], int(host.start[k]), int(host.end[k]),
                       int(host.frame[k]), number.get(int(host.parent[k]), -1),
                       names[host.detail[k]])
                  for k in (n & host.mask for n in keep)]
    log = st.launches
    lost = max(0, log.count - (log.mask + 1))
    dropped += lost
    frames: dict = {}
    for n in range(lost, log.count):
        k = n & log.mask
        key = (names[log.device[k]], names[log.program[k]])
        frames.setdefault(key, []).append(int(log.frame[k]))
    device_spans, fits = [], []
    for dev, ring in st.rings.items():
        second = ring.point()
        buf = ring.host if ring.cpu else ring.buf.cpu().numpy()
        count = int(buf[0])
        lost = max(0, count - ring.capacity)
        dropped += lost
        slots = np.arange(lost, count) & (ring.capacity - 1)
        stamps = buf[2:].reshape(-1, 2)[slots]
        to_host, err = fit(ring.first, second)
        name = str(dev)
        launch = {p: f for (d, p), f in frames.items() if d == name}
        base = len(device_spans)
        spans = _pair(stamps, to_host, launch, name)
        if spans:                   # the fit's uncertainty is that of the spans it placed
            fits.append(err)
        device_spans += [s._replace(parent=s.parent + base if s.parent >= 0 else -1)
                         for s in spans]
    return {"host": host_spans, "device": device_spans,
            "idle": _idle(device_spans, host_spans, st.window_lo, hi),
            "window_ns": (st.window_lo, hi), "fit_ns": max(fits, default=0),
            "dropped": dropped}
