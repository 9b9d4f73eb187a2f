"""Phase timing, spans and counters, and device traces (PyTorch).

Port of ``dynhor_tpu/utils/profiling.py``: per-phase seconds and an
optional ``torch.profiler`` trace of each phase, plus the recorder of the
spans and counters that the program keeps inside its loops.

Phases:

    prof = Profiler(device=dev)              # or trace_dir=... for traces
    with prof.phase("prior-scoring"):
        scores = ...
    prof.summary()   # prints and returns {phase: self seconds}

A phase on a CUDA device ends with ``torch.cuda.synchronize()``, so its
seconds include the device work it queued (the JAX package blocks on its
results inside each phase for the same reason).  Phases may nest; a
phase's seconds in ``summary`` are its self time, less the phases inside
it.  Set ``trace_dir`` (or env DYNHOR_TRACE_DIR) to write a Chrome trace
per outermost phase, ``<trace_dir>/<phase>.json``, with the recorder on
inside it, so that the phase and the spans below it appear in the trace.

Spans and counters:

    with recording() as rec:                 # the recorder on
        with span("refine.step"):
            ...
        count("prior.views_rescored", n)
    rec.totals(), rec.counters

Off (the default) ``span`` is one check of a module global and returns a
shared null context, and ``count`` returns at once: no allocation, no
``record_function``, no hook, no CUDA call.  On, each span keeps its name,
its parent, its thread and a host start and end, in memory, and enters
``torch.profiler.record_function(name)``, so that under an active
profiler it lies in the trace with the kernels it launches below it.  Its
stamps are on the profiler's clock: ``time.perf_counter_ns()`` plus an
offset to the Unix clock fixed when recording starts (the profiler's host
events are on the Unix clock: ``kineto_results.trace_start_ns()`` plus an
event's time range).  Counters are host integers; neither a span nor a
counter reads the device.

The program's spans and counters:

- ``refine.step``, ``.render``, ``.backward``, ``.adam``, ``.vit_fwd`` and
  ``.vit_bwd`` (the ViT's backward, ``span_between_grads``); counter
  ``refine.frame_steps``;
- ``prior.prescreen``, ``.rescore``, ``.frame_features``, ``.cap``,
  ``.calibrate``, ``.render``, ``.crop``, ``.vit``, ``.score``; counters
  ``prior.views_prescreened``, ``.views_rescored``, ``.cap_reruns``;
- ``neus.step``, ``.field``, ``.backward``, ``.sample``, ``.update``,
  ``.occupancy``; counter ``neus.rays``;
- ``neus.encode`` (the "ngp" field's hash-grid encoding, a call) and
  ``neus.encode_bwd`` (its backward on autograd's thread, from the
  encoding's gradient to the last of the table's and the points', and its
  double backward, from the gradient of the points' gradient to that of
  the encoding's gradient);
  counters ``neus.encoded_points`` (points a call) and ``neus.hash_lookups``
  (points x levels x 8 corners);
- counters ``vit.attn_kernel``, ``vit.attn_written_out``.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

_NULL = contextlib.nullcontext()
_REC: Recording | None = None  # the active recording; None: the recorder is off
_STACKS: dict[int, list] = {}  # thread ident -> the spans open on that thread


class Span:
    """One span: ``name``, ``parent`` (a Span or None), ``thread``
    (``threading.get_ident()``), ``start_ns`` and ``end_ns`` on the Unix
    clock.  A context manager; ``span()`` makes it."""

    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns", "_rec", "_rf")

    def __init__(self, name: str, rec: Recording, parent: Span | None = None):
        self.name, self._rec, self.parent = name, rec, parent
        self.thread = self.start_ns = self.end_ns = self._rf = None

    def __enter__(self) -> Span:
        self.thread = threading.get_ident()
        stack = _STACKS.setdefault(self.thread, [])
        if self.parent is None and stack:
            self.parent = stack[-1]
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self.start_ns = time.perf_counter_ns() + self._rec.offset_ns
        self._rf.__enter__()
        self._rec.spans.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        self.end_ns = time.perf_counter_ns() + self._rec.offset_ns
        self._rf = None
        stack = _STACKS[self.thread]
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Recording:
    """What the recorder kept while it was on: ``spans`` in the order they
    opened and ``counters`` {name: int}.  ``offset_ns`` maps
    ``time.perf_counter_ns()`` onto the Unix clock."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] += int(n)

    def totals(self) -> dict[str, tuple[int, float, float]]:
        """{name: (spans, seconds, self seconds)} over the closed spans; a
        span's self time is its own less its child spans'."""
        child = defaultdict(float)
        for s in self.spans:
            if s.end_ns is not None and s.parent is not None:
                child[id(s.parent)] += s.seconds
        out: dict[str, list] = {}
        for s in self.spans:
            if s.end_ns is None:
                continue
            t = out.setdefault(s.name, [0, 0.0, 0.0])
            t[0] += 1
            t[1] += s.seconds
            t[2] += max(s.seconds - child[id(s)], 0.0)
        return {k: tuple(v) for k, v in out.items()}


def span(name: str):
    """A span named ``name`` around a ``with`` block, below the span open on
    this thread; the shared null context when the recorder is off."""
    rec = _REC
    if rec is None:
        return _NULL
    return Span(name, rec)


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to the counter ``name`` (recorder on)."""
    rec = _REC
    if rec is not None:
        rec.add(name, n)


def active() -> bool:
    """Whether the recorder is on."""
    return _REC is not None


def span_between_grads(name: str, first: torch.Tensor, *lasts: torch.Tensor) -> None:
    """A span of the backward pass from the gradient of ``first`` to the
    last gradient of ``lasts`` that the pass computes (a module's output
    and its inputs: the module's backward), in each backward pass that
    reaches them.  Where the pass builds a graph of its own
    (``create_graph``), the backward of that backward gets a span of the
    same name in the later pass that takes it: from the first gradient of
    the inputs' gradients to that of the output's gradient (the module's
    double backward).  Autograd runs them on its own thread; their parent is
    the span open, when each starts, on the thread that registers them,
    which calls the backward.  Registers gradient hooks, which leave the
    gradients as they are, only while the recorder is on.  ``lasts`` are
    not leaves: of a leaf, autograd cannot say whether ``torch.autograd.grad``
    will reach it."""
    rec = _REC
    if rec is None or not first.requires_grad:
        return
    lasts = [t for t in lasts if t.requires_grad]
    if lasts:
        _between(name, rec, threading.get_ident(), [first], lasts)


def _will_reach(t: torch.Tensor) -> bool:
    """Whether the running backward pass computes the gradient of ``t``."""
    try:
        node = t.grad_fn or torch.autograd.graph.get_gradient_edge(t).node
        return bool(torch._C._will_engine_execute_node(node))
    except RuntimeError:  # a leaf in ``torch.autograd.grad``: counted as not reached
        return False


def _between(name: str, rec: Recording, owner: int, firsts: list, lasts: list) -> None:
    """Hooks for ``span_between_grads``: a span opens at the first gradient
    of ``firsts`` in a pass and closes at the last gradient of ``lasts``
    that the pass computes."""
    st = {"span": None, "left": 0, "out": None, "ins": [], "closed_in": None}

    def begin(grad):
        if st["span"] is not None or st["closed_in"] == torch._C._current_graph_task_id():
            return
        left = sum(_will_reach(t) for t in lasts)
        if left == 0:  # no input's gradient in this pass
            return
        stack = _STACKS.get(owner)
        st.update(left=left, out=grad, ins=[])
        st["span"] = Span(name, rec, stack[-1] if stack else None).__enter__()

    def end(grad):
        if st["span"] is None:
            return
        st["ins"].append(grad)
        st["left"] -= 1
        if st["left"] > 0:
            return
        st["span"].__exit__(None, None, None)
        out, ins = st["out"], [g for g in st["ins"] if g.requires_grad]
        st.update(span=None, out=None, ins=[], closed_in=torch._C._current_graph_task_id())
        if out.requires_grad and ins:
            _between(name, rec, owner, ins, [out])

    for t in firsts:
        t.register_hook(begin)
    for t in lasts:
        t.register_hook(end)


@contextlib.contextmanager
def recording():
    """Turn the recorder on for the block; yields the ``Recording`` it
    fills.  Nested, the inner block's spans and counters go to the outer
    recording too when it ends."""
    global _REC
    outer = _REC
    rec = Recording()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = outer
        if outer is not None:
            outer.spans.extend(rec.spans)
            for k, v in rec.counters.items():
                outer.add(k, v)


class Profiler:
    def __init__(
        self,
        trace_dir: str | None = None,
        enabled: bool = True,
        device: str | torch.device | None = None,
    ):
        self.trace_dir = trace_dir or os.environ.get("DYNHOR_TRACE_DIR")
        self.enabled = enabled
        self.device = torch.device(device) if device is not None else None
        self.times: dict[str, float] = {}  # self seconds per phase
        self._open: list[list[float]] = []  # per open phase, its child phases' seconds
        self._tracing = False

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        trace = None
        if self.trace_dir and not self._tracing:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device is not None and self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            trace = profile(activities=acts)
            self._tracing = True
        self._sync()
        children = [0.0]
        self._open.append(children)
        t0 = time.perf_counter()
        try:
            with trace if trace is not None else _NULL:
                with recording() if trace is not None and not active() else _NULL:
                    with span(name):
                        yield
                        self._sync()
        finally:
            dt = time.perf_counter() - t0
            self._open.pop()
            if self._open:
                self._open[-1][0] += dt
            self.times[name] = self.times.get(name, 0.0) + dt - children[0]
            if trace is not None:
                self._tracing = False
                os.makedirs(self.trace_dir, exist_ok=True)
                trace.export_chrome_trace(os.path.join(self.trace_dir, f"{name}.json"))

    def summary(self, printer=print) -> dict[str, float]:
        """Print and return each phase's self seconds."""
        if self.enabled and self.times:
            total = sum(self.times.values())
            for k, v in self.times.items():
                printer(f"[profile] {k}: {v:.2f}s ({100 * v / max(total, 1e-12):.0f}%)")
            printer(f"[profile] total: {total:.2f}s")
        return dict(self.times)
