"""Spans and counters of the port: where a request's host time goes.

``request(name)`` and ``span(name)`` are context managers that time one
stage of a request on the host.  While no ``torch.profiler`` profile is
recording they return one shared null context and do nothing else, so a
run that is not traced pays one flag check a site.  While one records,
each opens a ``torch.profiler.record_function(name)`` (the span lands in
the profiler's chrome trace as a ``user_annotation``, on the device
events' clock) and appends a record to a bounded list (``spans()``)::

    {"name", "id", "parent", "request", "start", "end"}

``start`` and ``end`` are ``time.perf_counter()`` seconds; ``parent`` is
the id of the span open around it on the same thread (None at the top).
``request(name)`` is a facade entry point: the outermost one opens a
request, whose id is its own span id and which every span inside it
carries, and its record also holds ``counters``, the change of every
counter over the request (those that changed).  A request opened inside
another one (a facade entry calling another) records nothing.

A span around queued device work measures the host's enqueue of it, and
whatever the host waits for inside it.  Span names hold ``/`` and never
``#``.

``count(name, n)`` adds to a counter whatever the profiler does.
``counters()`` is one flat snapshot: these counters, and every kernel
wrapper's ``.launches`` (``launch_counts()``), as ``launches/<wrapper>``
or ``launches/<wrapper>/<kind>``.  A wrapper that counts its launches is
registered where it is defined (``@counted``), so the enumeration is the
set of wrappers whose modules are loaded: one that is not loaded has
launched nothing.  The counters the port keeps:

* ``plan_cache_hit``, ``plan_cache_miss``: lookups of the plan and program
  caches (``lookup``);
* ``table_h2d_bytes``: bytes of tables handed to the device
  (``ops/apply.upload``, and each table part of the in-place chain);
* ``state_d2h_bytes``: bytes of state copied from a card to the host;
* ``state_joins``, ``state_join_overlapped``: joins of a state's parts
  from a card into one host array (``ops/apply.join_state``), and those
  whose host output was ready while the card still ran the state's work;
* ``gswap_peer_bytes``, ``gswap_local_bytes``: bytes a sharded state's
  half-block exchanges (``parallel/sharded.py`` ``swap_halves``, the
  ``qsim/gswap`` span) move between distinct devices, and within one (the
  kept halves, and partners' halves on the same device);
* ``inplace_mat_steps``, ``inplace_mono_steps``: the in-place chain's mat
  and mono steps (``kernels/split.py`` ``run_split_block``), on every
  device; counters, not launches.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import _profiler_enabled

SPAN_LIMIT = 1 << 16         # records kept; the oldest go first

_NULL = contextlib.nullcontext()
_counts: dict = {}
_records: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
_ids = itertools.count(1)
_local = threading.local()
_COUNTED: list = []          # the wrappers that count their launches


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "facade", "id", "parent", "request", "before",
                 "start", "_fn")

    def __init__(self, name: str, facade: bool):
        self.name = name
        self.facade = facade

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.request = (self.id if self.facade
                        else None if outer is None else outer.request)
        self.before = counters() if self.facade else None
        stack.append(self)
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self._fn.__exit__(*exc)
        _stack().pop()
        rec = {"name": self.name, "id": self.id, "parent": self.parent,
               "request": self.request, "start": self.start, "end": end}
        if self.facade:
            before = self.before
            rec["counters"] = {k: v - before.get(k, 0)
                               for k, v in counters().items()
                               if v != before.get(k, 0)}
        _records.append(rec)
        return False


def span(name: str):
    """A stage of the work, timed while the profiler records."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name, False)


def request(name: str):
    """A facade entry point: the outermost one on a thread opens a request
    and records the counters' change over it; one inside it records
    nothing."""
    if not _profiler_enabled() or any(s.facade for s in _stack()):
        return _NULL
    return _Span(name, True)


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def lookup(cache: dict, key):
    """``cache.get(key)``, counted as a plan-cache hit or miss."""
    got = cache.get(key)
    count("plan_cache_miss" if got is None else "plan_cache_hit")
    return got


def counted(fn):
    """Register ``fn``, a kernel wrapper that counts its launches in
    ``fn.launches`` (an int, or a dict by kind)."""
    _COUNTED.append(fn)
    return fn


def launch_counts() -> dict:
    """{(wrapper, kind or None): launches} of every counting wrapper (kind
    for the wrappers that count by kind)."""
    out = {}
    for fn in _COUNTED:
        if isinstance(fn.launches, dict):
            out.update(((fn, k), v) for k, v in fn.launches.items())
        else:
            out[(fn, None)] = fn.launches
    return out


def counters() -> dict:
    """{name: value} of every counter, launches included."""
    out = dict(_counts)
    for (fn, kind), v in launch_counts().items():
        out["launches/" + fn.__name__
            + ("" if kind is None else "/" + kind)] = v
    return out


def spans() -> list:
    """The span records kept, oldest first."""
    return list(_records)


def reset() -> None:
    """Drop the span records and set every counter, launches included, to
    0."""
    _records.clear()
    _counts.clear()
    for fn in _COUNTED:
        if isinstance(fn.launches, dict):
            fn.launches.update(dict.fromkeys(fn.launches, 0))
        else:
            fn.launches = 0
