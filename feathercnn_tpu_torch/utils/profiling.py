"""Tracing and per-layer timing — counterpart of
``feathercnn_tpu/utils/profiling.py``.

- ``record()``: the port's own spans and sync counter, off unless a caller
  enters it.  Inside it every ``Engine.run`` call is one ``run`` span and
  each graph node one ``node`` span, nested in it, around the node's
  lowering (each graph input one too, around its cast to the compute
  dtype); every synchronizing CUDA call made inside a ``run`` span is a
  ``Sync``, with the innermost open node, and every lookup of a node's
  kept constant (``ops.lowering.LoweringCtx.kept``) a ``Kept``, made or
  reused.  The node span is also the
  engine's only node scope: while a ``torch.profiler`` is on, it opens a
  ``record_function`` range named after the node, recording or not, so a
  profile gives device time per graph node.
- ``trace(logdir)``: a ``torch.profiler`` context whose trace (host ops,
  CUDA kernels, and those node ranges) lands in ``logdir`` as a
  ``*.pt.trace.json`` file that TensorBoard's profiler plugin and
  ``chrome://tracing`` read.
- ``layer_timings(engine, x)``: ms per node of the optimized graph.  The
  reference times growing prefixes of the graph (O(n^2) compiles, because
  XLA fuses across nodes); the port runs each node eagerly, so each node is
  timed directly on its own inputs: CUDA events around ``iters`` calls of
  its lowering on the card, ``time.perf_counter`` on the CPU.
- ``log``: the package's logger.
"""

from __future__ import annotations

import contextlib
import logging
import os
import statistics
import tempfile
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

log = logging.getLogger("feathercnn_tpu_torch")

__all__ = ["record", "Recording", "Span", "Sync", "Route", "Kept",
           "grouped_route", "kept_const", "consts_by_batch", "trace",
           "layer_timings", "log"]

# The start of the message of PyTorch's warning under
# ``torch.cuda.set_sync_debug_mode("warn")``.
SYNC_WARNING = "called a synchronizing CUDA operation"
ANCHOR_SYNCS = 3
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Span(NamedTuple):
    """One span of a recording, in host nanoseconds
    (``time.perf_counter_ns``).  ``kind`` is ``"run"`` (one
    ``Engine.run`` call; ``name`` "run", ``op`` "") or ``"node"`` (one
    graph node's lowering, its name and op type; or one graph input's cast
    to the compute dtype, its name and ``op`` "Input").  ``parent`` is the
    id of the span it is nested in (None for an outermost one); every span
    of one ``Engine.run`` call shares its ``batch``."""
    id: int
    parent: Optional[int]
    batch: int
    kind: str
    name: str
    op: str
    t0_ns: int
    t1_ns: int


class Sync(NamedTuple):
    """A synchronizing CUDA call inside a ``run`` span: its host time (when
    the call returned), the run's batch, the innermost open node span's
    name and op type (None between nodes), and the Python line that made
    the call (``path:line``, the path from the package's parent where the
    line is the package's)."""
    t_ns: int
    batch: int
    node: Optional[str]
    op: Optional[str]
    site: str


class Route(NamedTuple):
    """The route one grouped conv's lowering took, as
    ``kernels/dispatch.py::conv_forward`` chose it: the run's batch (None
    outside a ``run`` span), the node's name, the route and q.  ``route``
    is ``"supergroup"`` (the super-group kernel, q whole groups a column
    tile), ``"block_diagonal"`` (the GEMM kernels on the block-diagonal
    dense weight), ``"depthwise"`` (a depthwise kernel) or ``"float"``
    (PyTorch's float grouped conv); q is 0 off the super-group route."""
    batch: Optional[int]
    node: str
    route: str
    q: int


class Kept(NamedTuple):
    """One lookup of a node's kept constant (``LoweringCtx.kept``): the
    run's batch (None outside a ``run`` span), the node's name, the key
    and whether the lookup made it (a miss) or reused it (a hit).  A
    forward after the first of its shape makes none."""
    batch: Optional[int]
    node: str
    key: str
    made: bool


@dataclass
class Recording:
    """What ``record()`` hands over.  ``anchor_ns`` holds (before, after),
    in host nanoseconds, of each of ``ANCHOR_SYNCS`` calls of
    ``torch.cuda.synchronize()`` on an idle card, taken where recording
    started under an active ``torch.profiler`` (else empty): the i-th is
    the profile's i-th ``cudaDeviceSynchronize`` event, and the narrowest
    one's midpoint, matched with its event's, puts the spans on the
    profile's clock (the first call under a fresh profiler also pays
    for the profiler's set-up)."""
    spans: List[Span] = field(default_factory=list)
    syncs: List[Sync] = field(default_factory=list)
    routes: List[Route] = field(default_factory=list)
    consts: List[Kept] = field(default_factory=list)
    anchor_ns: List[Tuple[int, int]] = field(default_factory=list)


class _Recorder:
    """The open ``record()``: the stack of open spans (id, batch, kind,
    name, op, start), the ids to give next, and each sync site's file as a
    ``Sync`` names it."""

    def __init__(self):
        self.recording = Recording()
        self.open: list = []
        self.next_id = 0
        self.next_batch = 0
        self.paths: Dict[str, str] = {}

    def begin(self, kind: str, name: str, op: str) -> None:
        if kind == "run":
            batch, self.next_batch = self.next_batch, self.next_batch + 1
        else:
            batch = self.open[-1][1]
        self.open.append((self.next_id, batch, kind, name, op,
                          time.perf_counter_ns()))
        self.next_id += 1

    def end(self) -> None:
        t1 = time.perf_counter_ns()
        sid, batch, kind, name, op, t0 = self.open.pop()
        parent = self.open[-1][0] if self.open else None
        self.recording.spans.append(
            Span(sid, parent, batch, kind, name, op, t0, t1))

    def sync(self, filename: str, lineno: int) -> None:
        t = time.perf_counter_ns()
        runs = [s for s in self.open if s[2] == "run"]
        if not runs:
            return
        node = next((s for s in reversed(self.open) if s[2] == "node"),
                    None)
        path = self.paths.get(filename)
        if path is None:
            path = os.path.abspath(filename)
            if path.startswith(_PACKAGE_ROOT + os.sep):
                path = os.path.relpath(path, os.path.dirname(_PACKAGE_ROOT))
            self.paths[filename] = path
        self.recording.syncs.append(Sync(
            t, runs[-1][1], node and node[3], node and node[4],
            f"{path}:{lineno}"))

    def run_batch(self) -> Optional[int]:
        runs = [s for s in self.open if s[2] == "run"]
        return runs[-1][1] if runs else None

    def route(self, node: str, route: str, q: int) -> None:
        self.recording.routes.append(
            Route(self.run_batch(), node, route, q))

    def const(self, node: str, key: str, made: bool) -> None:
        self.recording.consts.append(
            Kept(self.run_batch(), node, key, made))


# The open recording; read once per ``Engine.run`` call.
_recorder: Optional[_Recorder] = None


def grouped_route(node: str, route: str, q: int = 0) -> None:
    """A ``Route`` of grouped conv ``node`` into the open recording; where
    no ``record()`` is open, one ``None`` check and nothing else."""
    if _recorder is not None:
        _recorder.route(node, route, q)


def kept_const(node: str, key: str, made: bool) -> None:
    """A ``Kept`` lookup of (node, key) into the open recording; where no
    ``record()`` is open, one ``None`` check and nothing else."""
    if _recorder is not None:
        _recorder.const(node, key, made)


def consts_by_batch(recording: Recording) -> Dict[Optional[int],
                                                  Tuple[int, int]]:
    """{batch: (constants made, constants reused)} of a recording's
    ``Kept`` lookups, by ``run`` span (None: outside one)."""
    out: Dict[Optional[int], Tuple[int, int]] = {}
    for k in recording.consts:
        made, reused = out.get(k.batch, (0, 0))
        out[k.batch] = (made + k.made, reused + (not k.made))
    return out


@contextlib.contextmanager
def record():
    """Record the port's spans, syncs, grouped conv routes and kept
    constants' lookups in the block; yields the ``Recording``, whose lists
    are whole when the block ends.  One thread, one recording at a time.
    On a CUDA host the block runs under
    ``torch.cuda.set_sync_debug_mode("warn")`` (the mode before it is set
    again after it) and PyTorch's sync warnings become ``Sync`` entries
    instead of being shown; under an active ``torch.profiler`` it
    first takes the clock anchor (``Recording.anchor_ns``), so enter it on
    an idle card inside the profiler's block."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("record() is already open")
    rec = _Recorder()
    cuda = torch.cuda.is_available()
    if cuda and torch.autograd._profiler_enabled():
        for _ in range(ANCHOR_SYNCS):
            t0 = time.perf_counter_ns()
            torch.cuda.synchronize()
            rec.recording.anchor_ns.append((t0, time.perf_counter_ns()))
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                rec.sync(filename, lineno)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        mode = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        _recorder = rec
        try:
            yield rec.recording
        finally:
            _recorder = None
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
            rec.recording.spans.sort(key=lambda s: s.id)


class _RunScope:
    """The spans of one ``Engine.run`` call: its ``run`` span (recording
    only) and, through ``wrap``, a ``node`` span around each node's
    lowering, which opens the node's ``record_function`` range while a
    profiler is on."""
    __slots__ = ("rec", "ranges")

    def __init__(self, rec: Optional[_Recorder], ranges: bool):
        self.rec, self.ranges = rec, ranges

    def __enter__(self):
        if self.rec is not None:
            self.rec.begin("run", "run", "")
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.end()

    def wrap(self, lower):
        """``lower`` (``lower_node``, ``lower_sharded`` or the engine's
        input cast: a node, or anything with its ``name`` and ``op``,
        first) inside the node's span; ``lower`` itself where nothing
        records and no profiler is on."""
        rec, ranges = self.rec, self.ranges
        if rec is None and not ranges:
            return lower

        def lower_in_span(node, *args):
            scope = (torch.profiler.record_function(node.name) if ranges
                     else contextlib.nullcontext())
            with scope:
                if rec is None:
                    return lower(node, *args)
                rec.begin("node", node.name, node.op)
                try:
                    return lower(node, *args)
                finally:
                    rec.end()
        return lower_in_span


_BARE = _RunScope(None, False)


def run_scope() -> _RunScope:
    """The span scope of one ``Engine.run`` call: where nothing records and
    no profiler is on, one that opens no span (the engine then lowers each
    node bare)."""
    ranges = torch.autograd._profiler_enabled()
    if _recorder is None and not ranges:
        return _BARE
    return _RunScope(_recorder, ranges)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block (CPU and, where there is one, CUDA activity) and
    write its trace into ``logdir`` (default: ``feathercnn_tpu_torch_trace``
    in the temporary directory) when it ends; yields ``logdir``."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "feathercnn_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


@torch.inference_mode()
def layer_timings(engine, x, iters: int = 5) -> Dict[str, float]:
    """{node name: ms} for every node of ``engine``'s optimized graph: the
    median over ``iters`` calls of the node's lowering on the inputs one
    forward of ``x`` (an array, or name -> array) gives it, after one
    warm-up call, on the engine's device.  The plain engine (no
    ``sharding``) only."""
    from ..ops.lowering import lower_node

    if engine._mesh is not None:
        raise ValueError("layer_timings times the plain engine; this one is "
                         "sharded")
    if not isinstance(x, dict):
        (name,) = engine.graph.inputs
        x = {name: x}
    cdtype = getattr(torch, engine.config.compute_dtype)
    env = {}
    for name, v in x.items():
        t = torch.as_tensor(v).to(engine.device)
        env[name] = t.to(cdtype) if (t.dtype.is_floating_point
                                     and t.dim() == 4) else t
    params = engine._prepare_params()
    cuda = engine.device.type == "cuda"
    out: Dict[str, float] = {}
    for node in engine.graph.nodes:
        ins = [env[i] for i in node.inputs]
        ps = [params[p] for p in node.params]

        def run():
            return lower_node(node, ins, ps, engine._ctx)

        vals = run()
        times = []
        for _ in range(iters):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
        out[node.name] = statistics.median(times) if times else 0.0
        for name, val in zip(node.outputs, vals):
            env[name] = val
    return out
