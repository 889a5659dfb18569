"""Spans and counters of the scheduler's hot path, recorded in memory.

Recording is off by default.  :func:`start` clears what was recorded and
turns it on; :func:`stop` turns it off and returns a :class:`Recording`.
Both are called between the program's calls, never inside one.

A span is a named interval with its parent, the span open around it when
it began.  The hottest sites test the flag :data:`on` inline and call
:func:`open_span` / :func:`close_span` only while it is set, so off they
cost one attribute read and a branch; the others use :func:`span` (a
context manager, a shared no-op while off) or :func:`spanned` (a
decorator).  Spans are stamped with ``time.time_ns``, the clock
``torch.profiler`` stamps its events with, so a span and a device
interval compare directly.  They are kept as parallel ``array('q')``
columns with interned names until :func:`stop`.

The recorder is single-threaded, as the hot path is: the parent is the
top of one module-level stack.

Spans (``name``: where, what it covers):

  * ``sched.policy``: ``schedule_on``, one schedule;
  * ``sched.sweep``: ``sjf_bco._sweep_columnar``, one bisection round's
    (theta, kappa) forest, its results gathered;
  * ``columnar.place`` / ``columnar.score``: ``ColumnarPlacement.place``
    (one job step) and ``_score`` (its candidates' pricing);
  * ``kernel.pick_orders`` (children ``pick_orders.pack``, filling the
    pinned buffer, and ``pick_orders.launch``: copy up, K3, copy back,
    wait), ``kernel.score_probes``;
  * ``kernel.tau_stack`` (children ``tau_stack.h2d``, packing the inputs
    into the pinned buffer, ``tau_stack.launch``, the one C call: copy up,
    K1/K2, copy back, wait, and ``tau_stack.d2h``, the copy out of the
    pinned buffer; on the CPU: the tensors made, the plain version, the
    arrays taken back);
  * ``sim.simulate``: one simulation;
  * ``daemon.round``, ``daemon.decide`` (one decision), ``daemon.chooser``
    (around the interval ``Daemon.decision_latencies`` holds),
    ``daemon.monitor``;
  * ``journal.append``: one journal entry.

What the spans count (steps, decisions, journal entries) is read from
:meth:`Recording.calls`; :data:`COUNTERS` holds what they do not.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from array import array

__all__ = ["COUNTERS", "Recording", "close_span", "on", "open_span",
           "span", "spanned", "start", "stop"]

#: What the hot path counts while recording (zeroed by :func:`start`);
#: a site adds to it only under ``if obs.on``.
COUNTERS = {
    "columnar.tries": 0,     # rounds of ColumnarPlacement's escalation ladder
    "pool.rows": 0,          # work rows handed to pick_orders (K3)
    "tau.rows": 0,           # C * J rows of the stacks tau_stack reduces
    "tau.regrows": 0,        # tau_stack calls that grew its staging buffers
}

#: Whether spans and counters are being recorded.
on = False
_ids: dict[str, int] = {}
_names: list[str] = []
_name = array("q")
_t0 = array("q")
_t1 = array("q")
_parent = array("q")
_stack: list[int] = []


def open_span(name: str) -> int:
    """Open a span under the innermost open one; its index, for
    :func:`close_span`.  Call only while :data:`on`."""
    k = _ids.get(name)
    if k is None:
        k = _ids[name] = len(_names)
        _names.append(name)
    i = len(_t0)
    _parent.append(_stack[-1] if _stack else -1)
    _stack.append(i)
    _name.append(k)
    t = time.time_ns()
    _t0.append(t)
    _t1.append(t)
    return i


def close_span(i: int) -> None:
    """Close span ``i`` and any child of it still open (one an exception
    left open)."""
    t = time.time_ns()
    while _stack and _stack[-1] >= i:
        _t1[_stack.pop()] = t


class _Span:
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        close_span(self.i)
        return False


class _Null:
    __slots__ = ()

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


def span(name: str):
    """A context manager recording one span while recording is on."""
    return _Span(open_span(name)) if on else _NULL


def spanned(name: str):
    """Decorator: each call of the function is one span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not on:
                return fn(*args, **kw)
            i = open_span(name)
            try:
                return fn(*args, **kw)
            finally:
                close_span(i)
        return call
    return wrap


def start() -> None:
    """Clear the spans and counters and turn recording on."""
    global on
    for col in (_name, _t0, _t1, _parent):
        del col[:]
    _stack.clear()
    _ids.clear()
    _names.clear()
    for key in COUNTERS:
        COUNTERS[key] = 0
    on = True


@dataclasses.dataclass(frozen=True)
class Recording:
    """What one :func:`start` .. :func:`stop` recorded.

    ``spans`` holds ``(name, t0, t1, parent)`` in the order they opened
    (``t0``/``t1`` in ``time.time_ns`` nanoseconds, ``parent`` an index
    into ``spans`` or -1); a span still open at :func:`stop` ends there,
    at ``t_stop``."""

    t_stop: int
    spans: list[tuple[str, int, int, int]]
    counters: dict[str, int]

    def intervals(self) -> list[tuple[str, int, int]]:
        """``(name, t0, t1)`` of every span."""
        return [(n, a, b) for n, a, b, _ in self.spans]

    def calls(self) -> dict[str, int]:
        """The number of spans of each name."""
        out: dict[str, int] = {}
        for n, *_ in self.spans:
            out[n] = out.get(n, 0) + 1
        return out

    def self_ns(self) -> list[int]:
        """Each span's duration less the part its child spans cover."""
        own = [b - a for _, a, b, _ in self.spans]
        for _, a, b, p in self.spans:
            if p >= 0:
                own[p] -= b - a
        return own

    def total_s(self) -> dict[str, float]:
        """Seconds inside spans of each name."""
        out: dict[str, int] = {}
        for n, a, b, _ in self.spans:
            out[n] = out.get(n, 0) + b - a
        return {n: v / 1e9 for n, v in out.items()}

    def self_s(self) -> dict[str, float]:
        """Self seconds (:meth:`self_ns`) of each name."""
        out: dict[str, int] = {}
        for (n, *_), v in zip(self.spans, self.self_ns()):
            out[n] = out.get(n, 0) + v
        return {n: v / 1e9 for n, v in out.items()}


def stop() -> Recording:
    """Turn recording off and return what it recorded."""
    global on
    t = time.time_ns()
    on = False
    for i in _stack:
        _t1[i] = t
    _stack.clear()
    names = _names
    spans = [(names[k], a, b, p) for k, a, b, p
             in zip(_name, _t0, _t1, _parent)]
    return Recording(t_stop=t, spans=spans, counters=dict(COUNTERS))
