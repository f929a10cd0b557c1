"""Named spans of the program's steps, on the profiler's clock.

``span(name)`` marks a part of a step: the training and predict steps and
their phases (``train/step.py``), the model's four layers
(``models/strajnet.py``), each SwinV2 block's position bias
(``strajnet.swinv2_cpb``, ``models/swin.py``). While no ``torch.profiler``
runs it returns a shared no-op context, at the cost of one check. While one
runs it does two things:

- it opens a profiler range of the name, recorded as a host operation
  (``cpu_op``), never as a user annotation, so that nothing of it is
  mirrored on the device's timeline;
- it keeps a record of the span in a bounded ring in memory, timed by
  ``time.time_ns()``, the clock of the profiler's events. A profile that
  records no host operations (CUDA activity alone) can still be read
  against the program's parts through it.

``spans()`` returns the ring's records in the order the spans opened;
``clear()`` empties it. A record is a :class:`Span`: ``parent`` is the
index, in the same list, of the enclosing span (-1 for an outermost span,
or where the ring has dropped it), and ``step`` the ordinal of the
outermost span, which every span of one step shares. Spans nest per thread;
they create no tensor and change nothing the step computes.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast

RING_SIZE = 65536


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int      # -1 while the span is open
    parent: int
    step: int


# [ordinal, name, start_ns, end_ns, parent's ordinal, step], in open order
_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_open = threading.local()
_span_ids, _step_ids = itertools.count(), itertools.count()
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if stack:
            parent, step = stack[-1][0], stack[-1][5]
        else:
            parent, step = -1, next(_step_ids)
        self.rec = [next(_span_ids), self.name, time.time_ns(), -1, parent,
                    step]
        _ring.append(self.rec)
        stack.append(self.rec)
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.rec[3] = time.time_ns()
        _open.stack.pop()
        return False


def span(name: str):
    """A context that marks ``name`` while a profiler runs, else nothing."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name)


def spans() -> List[Span]:
    """The ring's records, in the order their spans opened."""
    recs = list(_ring)
    if not recs:
        return []
    base = recs[0][0]
    return [Span(name, start, end, parent - base if parent >= base else -1,
                 step)
            for _, name, start, end, parent, step in recs]


def clear() -> None:
    _ring.clear()
