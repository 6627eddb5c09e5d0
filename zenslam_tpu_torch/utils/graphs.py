"""Captured programs — the counterpart of ``jax.jit(fn, static_argnames=...,
donate_argnames=...)`` as the reference applies it to ``slam_step``, the
keyframe path's programs (``pipeline/system.py``), the back end's public
solvers at their own entry points (``backend/ba.py``, ``pose_graph.py``,
``bow.py``, ``keyframes.py``, ``map_archive.py``, ``parallel/dist_ba.py``)
and the library functions of the front end, IMU, estimators, telemetry and
device render (``ops/``, ``imu/``, ``estimation/``,
``pipeline/state.py:pack_telemetry``, ``io/synthetic.py``).

On CUDA a ``Program`` captures its function into a CUDA graph once for each
combination of its static arguments, of its inputs' structure, non-tensor
leaves, shapes, dtypes and devices, and of the settings that choose kernels
(deterministic algorithms, TF32), as jit traces once for each, and replays
that graph on every later call:

- The inputs live in static buffers that the program owns. A call copies in
  every tensor whose storage is not already its buffer, in one
  ``torch._foreach_copy_``. The caller's tensors are never written.
- Traced scalars (``scalar_argnames``): a Python int passed there goes up as
  a 0-d int64 device tensor and a Python float as a 0-d float32 one, all of
  a call's in one upload from pinned memory that does not synchronise, so
  one capture serves every value (as jit traces a Python number it is not
  told is static). A float is traced only where the function turns it into
  a float32 tensor itself (the same bits either way): an op with a Python
  float is computed otherwise on CUDA than with a 0-d tensor (division
  multiplies by the reciprocal). Other non-tensor leaves are part of the
  key by value.
- A donated argument's new value (the matching leading element of the
  function's output tuple) is copied, at the end of the graph, into that
  argument's own buffers, and the call returns those buffers: given back to
  the next call they are copied nowhere (``donate_argnames``). The copy is
  part of the graph, so it costs no launch of its own.
- The other outputs are the graph's static outputs: each call overwrites the
  previous call's. A caller that keeps one past the next call copies it
  (``fresh``). With ``copy_outputs`` the program does so itself: what it
  returns is the caller's, as a jitted function's fresh arrays are (the
  back end's public entry points).
- The first call warms the function up on a side stream, on the buffers
  (copies of the caller's tensors, so the warm-up never touches the
  caller's state), then captures it. A capture that fails raises; nothing
  falls back to the eager form.
- Nesting (jit's rule): a program called while another program's function
  runs (its warm-up, its capture, its CPU run, or its call under
  ``eager()``), or inside a function wrapped by ``inline_programs`` (the
  eager ``slam_step``), runs its own function inline, with no key,
  buffers, capture, counters or generator seeding of its own: the outer
  program is what it would be with a plain function there. So does a
  program called while the current CUDA stream is capturing a graph of
  someone else's (jit inside another trace): it is recorded there as plain
  kernels.
- Counters that count Python calls, which a replay does not make: the hand
  kernels' launches (``lk_ragged.launches``, ``orb_steered_brief.launches``),
  the sharded solver's all-reduces and their floats
  (``parallel/dist_ba.py:collectives``) and the device stamps
  (``utils/tracing.py:counters``). The capture records each counter's
  increase and every call adds it. The warm-up and the capture themselves
  count nothing.
- Tracing (``utils/tracing.py``): while it is on, a program stamps the
  device at its first and last node under its name (its warm-up stamps
  nothing), logs each call, and its capture is a ``graphs.capture`` host
  span. The switch is part of every key.
- Random draws: a static argument with a ``seeded_generators()`` method
  (``backend/bow.py:GeneratorDraw``) names ``torch.Generator``s and their
  seeds. Each is seeded afresh before every run of the function (the
  warm-up, the capture, every replay, every CPU run and every call under
  ``eager()``), so each call draws what a freshly seeded generator draws,
  bit for bit; a capture registers each with its graph, whose replays
  read the generator's seed and offset as they stand at the replay. A
  static ``torch.Generator`` is registered likewise but not reseeded: its
  draws advance from call to call as eager draws do (the warm-up's draws
  are undone before the capture). A
  static argument left None can be given a default made on the inputs'
  device (``static_defaults``), so that a default generator is one the
  graph knows.
- A collective (``torch.distributed.all_reduce`` on an NCCL group) is
  captured as any kernel is: the warm-up call creates the communicator
  before the capture, and every rank of the group captures at the same
  call, since every rank makes the same calls with the same keys.

On the CPU the same buffer logic runs the function on the buffers instead
of replaying a graph, so the CPU tests exercise it.

``eager()`` is the counterpart of ``jax.disable_jit``: under it every
program calls its function directly, as plain PyTorch. It is the only way
to get the eager form on CUDA.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import numbers
import weakref

import numpy as np
import torch

from zenslam_tpu_torch.utils import tracing
from zenslam_tpu_torch.utils.device import upload

_EAGER_DEPTH = 0
_INLINE_DEPTH = 0    # programs' functions running now: a program called inside runs inline
_PROGRAMS = weakref.WeakSet()
_TENSOR = object()   # a tensor's place in a flattened tree
_LEAF = object()     # a non-tensor leaf (part of the key)


@contextlib.contextmanager
def eager():
    """Run every ``Program`` as its plain function inside the block (the
    counterpart of ``jax.disable_jit``)."""
    global _EAGER_DEPTH
    _EAGER_DEPTH += 1
    try:
        yield
    finally:
        _EAGER_DEPTH -= 1


def graphs_on() -> bool:
    """Whether programs capture and replay (False inside ``eager()``)."""
    return _EAGER_DEPTH == 0


@contextlib.contextmanager
def _running():
    """A program's function runs inside the block: programs it calls run
    inline (jit's nesting rule)."""
    global _INLINE_DEPTH
    _INLINE_DEPTH += 1
    try:
        yield
    finally:
        _INLINE_DEPTH -= 1


def inline_programs(fn):
    """``fn`` with every program it calls run inline (jit's nesting rule),
    as inside a program's function: the eager counterpart of a function
    that the reference compiles as a whole (``slam_step``,
    ``orb_descriptors_kernel``) captures nothing of its own."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _running():
            return fn(*args, **kwargs)

    return run


def _counters() -> tuple:
    """(object, attribute) of every counter a replay must advance."""
    from zenslam_tpu_torch.ops.lk_cuda import lk_ragged
    from zenslam_tpu_torch.ops.orb_cuda import orb_steered_brief
    from zenslam_tpu_torch.parallel.dist_ba import collectives

    return ((lk_ragged, "launches"), (orb_steered_brief, "launches"), (collectives, "calls"),
            (collectives, "floats"), (tracing.counters, "stamps"))


def _read_all() -> tuple:
    return tuple(getattr(c, a) for c, a in _counters())


def read_counters() -> tuple:
    """The hand kernels' launch counts, (LK, ORB)."""
    return _read_all()[:2]


def _set_counters(values) -> None:
    for (c, a), v in zip(_counters(), values):
        setattr(c, a, v)


def flatten(tree, leaves: list):
    """Append ``tree``'s tensors to ``leaves`` in order; return a hashable
    spec of the rest: containers (tuples, named tuples, lists, dicts) and
    non-tensor leaves."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _TENSOR
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        keys = tuple(tree)
        return (dict, keys, tuple(flatten(tree[k], leaves) for k in keys))
    return (_LEAF, tree)


def unflatten(spec, leaves):
    """Inverse of ``flatten``: ``leaves`` an iterator of tensors."""
    if spec is _TENSOR:
        return next(leaves)
    kind = spec[0]
    if kind is _LEAF:
        return spec[1]
    if kind is dict:
        return {k: unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    items = [unflatten(s, leaves) for s in spec[1]]
    if kind in (tuple, list):
        return kind(items)
    return kind(*items)


def fresh(tree):
    """``tree`` with its tensors copied while programs replay (a static
    output kept past the next call), unchanged under ``eager()``."""
    if not graphs_on():
        return tree
    leaves = []
    spec = flatten(tree, leaves)
    return unflatten(spec, iter([t.clone() for t in leaves]))


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


def _copy(dst: list, src: list) -> None:
    if dst:
        torch._foreach_copy_(dst, src)


_SIDE_STREAMS: dict = {}


def _side_stream(dev: torch.device):
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev]


def _generators(static: dict) -> list:
    """The (generator, seed) pairs that the static arguments draw from, the
    seed None for a ``torch.Generator`` passed as it is (see the module
    docstring)."""
    pairs = []
    for v in static.values():
        if hasattr(v, "seeded_generators"):
            pairs.extend(v.seeded_generators())
        elif isinstance(v, torch.Generator):
            pairs.append((v, None))
    return pairs


def _reseed(pairs: list) -> None:
    for g, seed in pairs:
        if seed is not None:
            g.manual_seed(seed)


def _settings() -> tuple:
    """The global settings that choose kernels: part of every key, as a
    changed flag makes jit trace anew; with them the multiply-add form of
    the blurs and the ORB moments (``ops/image.py:fma``, the fused op or
    its float64 emulation), which a caller may swap; and whether tracing
    stamps the device."""
    from zenslam_tpu_torch.ops import image, orb

    return (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
            image.fma, orb.fma, tracing.enabled())


class _Captured:
    """One captured program: its buffers, its graph (CUDA) and its static
    outputs."""

    def __init__(self, program: "Program", static: dict, specs: dict, ranges: dict,
                 leaves: list):
        # the program's function and names, not the program: no reference cycle
        # keeps a dropped program's graph and buffers alive
        self.fn, self.name = program.fn, program.__name__
        self.donate_argnames = program.donate_argnames
        self.static, self.specs, self.ranges = static, specs, ranges
        self.dev = leaves[0].device
        self.cuda = self.dev.type == "cuda"
        self.generators = _generators(static)
        self.bufs = [t.detach().clone() for t in leaves]
        self.graph = None
        self.out_spec = None
        self.outs = None
        self.launches = (0,) * len(_counters())
        self.calls = 0

    def _args(self) -> dict:
        it = iter(self.bufs)
        args = {n: unflatten(s, it) for n, s in self.specs.items()}
        args.update(self.static)
        return args

    def _run(self) -> tuple:
        """The function on the buffers between the program's device stamps,
        its donated outputs copied back (``_donate``)."""
        tracing.begin(self.name, self.dev)
        out = self._donate(self.fn(**self._args()))
        tracing.end(self.name, self.dev)
        return out

    def _donate(self, out) -> tuple:
        """Copy the donated arguments' new values into their buffers; return
        (output spec, output leaves with each donated leaf its buffer)."""
        n_don = len(self.donate_argnames)
        if n_don and not (isinstance(out, tuple) and len(out) >= n_don):
            raise ValueError(f"{self.name}: donating {n_don} argument(s) needs a "
                             "tuple output that leads with their new values")
        leaves = []
        spec = flatten(out, leaves)
        in_storage = {b.untyped_storage().data_ptr() for b in self.bufs}
        dst, src = [], []
        pos = 0
        for i, name in enumerate(self.donate_argnames):
            sub = []
            flatten(out[i], sub)
            lo, hi = self.ranges[name]
            if [(t.shape, t.dtype) for t in sub] != [(b.shape, b.dtype) for b in self.bufs[lo:hi]]:
                raise ValueError(f"{self.name}: the new {name!r} differs in "
                                 "structure, shape or dtype from the one passed")
            for k, t in enumerate(sub):
                b = self.bufs[lo + k]
                if not _same_memory(t, b):
                    dst.append(b)
                    src.append(t.clone() if t.untyped_storage().data_ptr() in in_storage else t)
                leaves[pos + k] = b
            pos += len(sub)
        _copy(dst, src)
        return spec, leaves

    def capture(self) -> None:
        """Warm up, then capture (CUDA); on the CPU the first run."""
        saved = _read_all()
        try:
            _reseed(self.generators)
            if not self.cuda:
                before = saved
                with _running():
                    self.out_spec, self.outs = self._run()
            else:
                side = _side_stream(self.dev)
                side.wait_stream(torch.cuda.current_stream(self.dev))
                states = [(g, g.get_state()) for g, seed in self.generators if seed is None]
                with torch.cuda.stream(side), _running(), tracing.muted():
                    self.fn(**self._args())                # the warm-up: results dropped
                torch.cuda.current_stream(self.dev).wait_stream(side)
                for g, st in states:                       # its draws undone
                    g.set_state(st)
                before = _read_all()
                graph = torch.cuda.CUDAGraph()
                for g, _ in self.generators:
                    graph.register_generator_state(g)
                _reseed(self.generators)
                with torch.cuda.graph(graph, stream=side), _running():
                    self.out_spec, self.outs = self._run()
                self.graph = graph
            self.launches = tuple(a - b for a, b in zip(_read_all(), before))
        finally:
            _set_counters(saved)

    def __call__(self, leaves: list):
        self.calls += 1
        dst, src = [], []
        for i, t in enumerate(leaves):
            b = self.bufs[i]
            if not (t is b or _same_memory(t, b)):
                dst.append(b)
                src.append(t)
        _copy(dst, src)
        tracing.launched(self.name, self.dev)
        if self.graph is not None:
            _reseed(self.generators)
            self.graph.replay()
        elif self.outs is None:
            with tracing.span("graphs.capture", self.name):
                self.capture()
        else:
            _reseed(self.generators)
            saved = _read_all()
            try:
                with _running():
                    _, outs = self._run()
            finally:
                _set_counters(saved)
            keep = [(a, b) for a, b in zip(self.outs, outs) if not _same_memory(a, b)]
            _copy([a for a, _ in keep], [b for _, b in keep])
        _set_counters(tuple(c + d for c, d in zip(_read_all(), self.launches)))
        return unflatten(self.out_spec, iter(self.outs))


def _traced_int(v) -> bool:
    return isinstance(v, numbers.Integral) and not isinstance(v, (bool, np.bool_))


def _traced_float(v) -> bool:
    return isinstance(v, (float, np.floating))


def _upload_scalars(ints: list, floats: list, dev) -> tuple:
    """The traced ints (int64) and floats (float32) as 0-d tensors on
    ``dev``, from one upload of their bytes."""
    raw = np.concatenate([np.array(ints, np.int64).view(np.uint8),
                          np.array(floats, np.float32).view(np.uint8)])
    up = upload(raw, dev)
    n = 8 * len(ints)
    return (tuple(up[:n].view(torch.int64)) if ints else (),
            tuple(up[n:].view(torch.float32)) if floats else ())


class Program:
    """``fn`` captured once per key and replayed (see the module docstring).
    ``static_argnames``: arguments that are part of the key by value (jit's
    ``static_argnames``); ``donate_argnames``: arguments whose new values lead
    ``fn``'s output tuple, in that order, and take over their buffers;
    ``scalar_argnames``: arguments whose Python ints (floats) reach ``fn``
    as 0-d int64 (float32) device tensors, not part of the key;
    ``static_defaults``: static argument -> ``make(device)``, the value
    that stands for None there;
    ``copy_outputs``: return copies the caller owns instead of the static
    outputs."""

    def __init__(self, fn, static_argnames=(), donate_argnames=(), scalar_argnames=(),
                 static_defaults=None, copy_outputs: bool = False):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.signature = inspect.signature(fn)
        self.static_argnames = tuple(static_argnames)
        self.donate_argnames = tuple(donate_argnames)
        self.scalar_argnames = tuple(scalar_argnames)
        self.static_defaults = dict(static_defaults or {})
        self.copy_outputs = copy_outputs
        self.captured: dict = {}
        _PROGRAMS.add(self)

    def __call__(self, *args, **kwargs):
        if _INLINE_DEPTH:        # inside another program's function: inlined, as jit does
            return self.fn(*args, **kwargs)
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        static = {n: bound.arguments[n] for n in self.static_argnames}
        if not graphs_on():
            return self._inline(static, args, kwargs)
        ints = {n: bound.arguments[n] for n in self.scalar_argnames
                if _traced_int(bound.arguments[n])}
        floats = {n: bound.arguments[n] for n in self.scalar_argnames
                  if _traced_float(bound.arguments[n])}
        leaves, specs, ranges = [], {}, {}
        for name, value in bound.arguments.items():
            if name in static or name in ints or name in floats:
                continue
            lo = len(leaves)
            specs[name] = flatten(value, leaves)
            ranges[name] = (lo, len(leaves))
        if not leaves:
            raise ValueError(f"{self.__name__}: no tensor input to capture")
        dev = leaves[0].device
        if any(t.device != dev for t in leaves):
            raise ValueError(f"{self.__name__}: every tensor input must be on one device")
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return self._inline(static, args, kwargs)     # inside another's capture
        if ints or floats:    # one upload for the call's traced scalars
            up_i, up_f = _upload_scalars([int(v) for v in ints.values()],
                                         [float(v) for v in floats.values()], dev)
            for name, t in zip((*ints, *floats), (*up_i, *up_f)):
                specs[name] = _TENSOR
                ranges[name] = (len(leaves), len(leaves) + 1)
                leaves.append(t)
        for name, make in self.static_defaults.items():
            if static[name] is None:
                static[name] = make(dev)
        key = (tuple(static.items()), tuple(specs.items()),
               tuple((tuple(t.shape), t.dtype, t.device) for t in leaves), _settings())
        entry = self.captured.get(key)
        if entry is None:
            entry = _Captured(self, static, specs, ranges, leaves)
            if entry.cuda:
                with tracing.span("graphs.capture", entry.name):
                    entry.capture()
            self.captured[key] = entry
        out = entry(leaves)
        if not self.copy_outputs:
            return out
        outs = []
        spec = flatten(out, outs)
        return unflatten(spec, iter([t.clone() for t in outs]))

    def _inline(self, static: dict, args, kwargs):
        """The plain function, its generators seeded as on every run."""
        _reseed(_generators(static))
        with _running():
            return self.fn(*args, **kwargs)


def graphs_held() -> int:
    """Captured programs alive (CUDA graphs, or their CPU counterparts)."""
    return sum(len(p.captured) for p in _PROGRAMS)


def calls(program: Program, **static) -> int:
    """The calls (replays on CUDA) of ``program``'s captured programs whose
    static arguments include ``static``."""
    return sum(c.calls for c in program.captured.values()
               if all(c.static.get(k) == v for k, v in static.items()))
