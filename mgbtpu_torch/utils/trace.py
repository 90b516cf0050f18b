"""Spans and counters of the port's layers.

Spans name the work of a layer on the ``torch.profiler`` timeline: while a
profiler records (``mgb_solve(profile_dir=...)``, or one the caller runs),
``span(name)`` enters ``torch.profiler.record_function(name)``, which the
trace keeps as a user annotation on the clock of the device's activity;
while none records it returns one shared no-op context, so a span costs one
flag test and enters nothing. A span syncs nothing. Every name begins with
its layer: ``driver``, ``setup``, ``newton``, ``linsolve`` or ``levelfn``.

Counters:

- ``ENQUEUE_NS``: host nanoseconds inside each hand kernel's wrapper
  (argument checks, allocation, the launch), by the kernel's name in
  ``kernels.WRAPPERS``; counted only while a profiler records.
- ``BUILDS``: what a solve had to build: "problem_kernels" (a new
  per-problem solver), "panel_ops" (a level's panel operators),
  "large_context" (a large level's ND plan or V-cycle/FSAI data),
  "kernel_entry" (a kernel entry loaded from its library); always counted.
- ``solves()``: while a profiler records, ``solve`` keeps one record a
  solve that returns: its number ``seq`` and the deltas over the solve of
  the counters its caller reads (the kernels' launches, the Newton syncs,
  the mesh's transfers, ``ENQUEUE_NS`` and ``BUILDS``).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch
from torch.profiler import record_function

recording = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()

ENQUEUE_NS: collections.Counter = collections.Counter()
BUILDS: collections.Counter = collections.Counter()
SEQ = {"n": 0}          # the number of the last solve begun
_SOLVES: collections.deque = collections.deque(maxlen=1024)


def span(name: str):
    """A context that records the span ``name`` while a profiler records,
    and the shared no-op context otherwise."""
    if not recording():
        return _OFF
    return record_function(name)


def spanned(name: str):
    """Decorate a function to run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def enqueue(kernel: str):
    """Decorate a hand kernel's wrapper to add its host nanoseconds to
    ``ENQUEUE_NS[kernel]`` while a profiler records."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                ENQUEUE_NS[kernel] += time.perf_counter_ns() - t0
        return inner
    return wrap


def built(what: str):
    BUILDS[what] += 1


def _delta(before, after):
    if isinstance(after, dict):
        before = before or {}
        return {k: _delta(before.get(k), v) for k, v in after.items()}
    return after - (before or 0)


@contextlib.contextmanager
def solve(counters):
    """The span ``driver.solve`` of one solve, its number as the span's
    args; yields the number. While a profiler records, a solve that returns
    leaves its record in ``solves()``: ``seq`` and the deltas of
    ``counters()`` (a dict of numbers and dicts of numbers) over it."""
    SEQ["n"] += 1
    seq = SEQ["n"]
    if not recording():
        yield seq
        return
    before = counters()
    with record_function("driver.solve", str(seq)):
        yield seq
    _SOLVES.append({"seq": seq, **_delta(before, counters())})


def solves() -> list:
    """The kept solve records, oldest first (the last 1,024)."""
    return list(_SOLVES)
