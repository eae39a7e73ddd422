"""Spans and counters of the program's own work: one recorder, always on.

An operator running a chain of lightcones reads each cone's host seconds and
counts by stage, with no profiler running: after the chain, `runs()` holds
one entry a `generate_lightcone` call (or a `generate_coeval` called on its
own), the last 64 of them, and `totals()` the whole process.

    with tracing.span("ts.host_tables"):
        ...
    tracing.count("h2d.uploads")

- A span is booked under its name with its parent (the innermost span open
  on its thread when it first ran), how many times it ran and its seconds
  (`time.perf_counter_ns`).  Its self time is its seconds less those of its
  children (`self_seconds`).
- A counter is booked under its stage: the open span of its thread whose
  parent is `node` or nothing (`h2d.uploads` under `ts`); "node" when only
  the node span is open, None when none is.
- Bookings go into the current run's current node (a node of the coeval
  scroll: its index and z), into the run itself outside any node (the
  lightcone's finalization), and always into the process totals.  Work
  outside any run (the ICs on their own, the sharded drivers) goes only into
  the totals.  A worker thread books into the run and node that gave it its
  work (`here()`, then `span(name, at=...)`); one name is booked into one
  book from one thread at a time (the SFRD prefetch worker books only
  `ts.sfrd_build`), so no booking needs a lock.

A span costs about a microsecond and a count less.  While a torch profiler
records, each span also opens a `RecordFunctionFast` range of its name: a host
`cpu_op` event on the profiler's clock, beside the device's, so a trace's idle
gaps can be put down to the program's spans.  (`torch.profiler.record_function`
would make a `user_annotation`, which kineto mirrors as a device range, and
costs over ten microseconds with no profiler running.)  The recorder keeps no
event list and exports nothing.
"""

from __future__ import annotations

import collections
import functools
import threading
from time import perf_counter_ns

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["span", "count", "runs", "totals", "reset", "self_seconds", "here",
           "begin_node", "end_node", "traced_run"]

MAX_RUNS = 64


class _Book:
    """Spans as name -> [count, ns, parent], counters as (name, stage) -> n."""

    __slots__ = ("spans", "counters")

    def __init__(self):
        self.spans = {}
        self.counters = {}

    def add(self, other: _Book) -> None:
        for name, (n, ns, parent) in list(other.spans.items()):
            e = self.spans.setdefault(name, [0, 0, parent])
            e[0] += n
            e[1] += ns
        for key, n in list(other.counters.items()):
            self.counters[key] = self.counters.get(key, 0) + n


class _Node:
    __slots__ = ("index", "z", "book")

    def __init__(self, index, z):
        self.index, self.z, self.book = int(index), float(z), _Book()


class _Run:
    __slots__ = ("entry", "book", "nodes", "node")

    def __init__(self, entry):
        self.entry, self.book, self.nodes, self.node = entry, _Book(), [], None

    def books(self):
        return [self.book] + [n.book for n in list(self.nodes)]


class _Thread(threading.local):
    def __init__(self):
        # the open spans, innermost last: (name, stage, parent, book,
        # profiler range, start ns)
        self.stack = []
        self.run = None
        self.book = _outside  # where this thread's work is booked now


_runs: collections.deque = collections.deque(maxlen=MAX_RUNS)
_outside = _Book()  # work outside any run
_retired = _Book()  # the runs that fell out of `_runs`
_tls = _Thread()


def here() -> _Book:
    """The book that work on this thread goes into now: the current node's,
    the run's outside any node, or that of work outside any run."""
    return _tls.book


class _Span:
    """The context manager of `span`; what one entry needs lives on the
    thread's stack, so one object serves every entry of its name."""

    __slots__ = ("name", "at")

    def __init__(self, name, at):
        self.name = name
        self.at = at

    def __enter__(self):
        t = _tls
        stack = t.stack
        name = self.name
        if stack:
            parent, stage = stack[-1][0], stack[-1][1]
            if stage == "node":
                stage = name
        else:
            parent, stage = None, name
        rf = None
        if _autograd_profiler._is_profiler_enabled:
            rf = _RecordFunctionFast(name)
            rf.__enter__()
        stack.append((name, stage, parent, self.at or t.book, rf, perf_counter_ns()))
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = perf_counter_ns()
        name, _, parent, book, rf, t0 = _tls.stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        e = book.spans.get(name)
        if e is None:
            book.spans[name] = [1, t1 - t0, parent]
        else:
            e[0] += 1
            e[1] += t1 - t0
        return False


_spans_by_name: dict = {}


def span(name: str, at: _Book | None = None) -> _Span:
    """A context manager that books its seconds under `name`; `at` is a book
    from `here()` on another thread, for work done on its behalf."""
    if at is not None:
        return _Span(name, at)
    s = _spans_by_name.get(name)
    if s is None:
        s = _spans_by_name[name] = _Span(name, None)
    return s


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` under the stage open on this thread
    (`n` = 0 books the counter without moving it)."""
    t = _tls
    stack = t.stack
    key = (name, stack[-1][1] if stack else None)
    c = t.book.counters
    c[key] = c.get(key, 0) + n


def begin_node(index: int, z: float) -> None:
    """Book what follows on this thread into a new node of the current run
    (no-op outside a run)."""
    t = _tls
    if t.run is not None:
        t.run.node = _Node(index, z)
        t.run.nodes.append(t.run.node)
        t.book = t.run.node.book


def end_node() -> None:
    """Book what follows into the run itself, outside any node."""
    t = _tls
    if t.run is not None:
        t.run.node = None
        t.book = t.run.book


def traced_run(gen_fn):
    """Make each call of the generator function `gen_fn` a run of its own,
    current on the calling thread while the generator runs, unless it is
    iterated inside another run (the lightcone's coeval scroll)."""

    @functools.wraps(gen_fn)
    def wrapper(*args, **kwargs):
        gen = gen_fn(*args, **kwargs)
        t = _tls
        if t.run is not None:
            return (yield from gen)
        run = _Run(gen_fn.__name__)
        if len(_runs) == _runs.maxlen:
            for book in _runs[0].books():
                _retired.add(book)
        _runs.append(run)
        try:
            while True:
                outer = t.run, t.book
                t.run, t.book = run, (run.book if run.node is None else run.node.book)
                try:
                    item = next(gen)
                except StopIteration as stop:
                    return stop.value
                finally:
                    t.run, t.book = outer
                yield item
        finally:
            gen.close()

    return wrapper


def _spans(book):
    return {k: (e[0], e[1] * 1e-9, e[2]) for k, e in list(book.spans.items())}


def _counters(book):
    out = {}
    for (name, stage), n in list(book.counters.items()):
        out.setdefault(name, {})[stage] = n
    return out


def runs(last: int | None = None) -> list[dict]:
    """The kept runs, oldest first (the last `last` of them when given): each
    {"entry", "spans", "counters", "nodes"}, where `spans` maps a name to
    (count, seconds, parent), `counters` a name to {stage: n}, and each of
    `nodes` is {"index", "z", "spans", "counters"}; a run's own spans and
    counters are those outside its nodes."""
    kept = list(_runs)
    if last is not None:
        kept = kept[-last:] if last > 0 else []
    return [{"entry": r.entry, "spans": _spans(r.book), "counters": _counters(r.book),
             "nodes": [{"index": n.index, "z": n.z, "spans": _spans(n.book),
                        "counters": _counters(n.book)} for n in list(r.nodes)]}
            for r in kept]


def totals() -> dict:
    """The process's bookings, in runs or outside them: {"spans",
    "counters"} as in `runs()`."""
    out = _Book()
    for book in [_retired, _outside] + [b for r in list(_runs) for b in r.books()]:
        out.add(book)
    return {"spans": _spans(out), "counters": _counters(out)}


def reset() -> None:
    """Forget every run and the process totals."""
    _runs.clear()
    for book in (_outside, _retired):
        book.spans.clear()
        book.counters.clear()


def self_seconds(spans: dict, name: str) -> float:
    """A span's seconds less those of the spans booked with it as parent,
    in one `spans` mapping of `runs()` or `totals()`."""
    return spans[name][1] - sum(s for _, s, parent in spans.values() if parent == name)
