"""Traces of whole steps, reduced to what the per-layer metrics read.

The traced run profiles its steps twice, each pass over whole steps:

- the timeline pass records the card's activity alone (``torch.profiler``
  with CUDA activity: kernels, copies, sets and the host's CUDA calls), so
  that the profiler adds little host work and the steps keep their pace.
  From it: the span, from the first step's range (or, where the trace holds
  none, its first device operation) to the last device operation's end; the
  device's busy time, the union (not the sum) of every kernel, copy and
  set's interval in the span; the idle gaps between them, each named by the
  host's CUDA call in flight where the gap begins (``host`` where there is
  none) and the kernel that ends it; the device time of each kernel name.
- the attribution pass records the host's operations too (CPU activity),
  which slows the host but not the kernels: a kernel is tied to the host's
  launch call of the same correlation id, and through the call's thread and
  time to the host operations around it (an ``autograd.Function``'s forward
  is recorded under the class's name, its backward node under the name
  plus ``Backward``). From it: the device time of the kernels launched
  inside host operations of given names.

Each step runs inside a ``record_function`` range of the benchmark's own
(``bench.step``).
"""

from __future__ import annotations

import bisect
import collections
from typing import Callable, Dict, Iterable, List, Optional

import torch

STEP = "bench.step"
_CALL_PREFIXES = ("cuda", "cu")


def _split(events):
    """(host events, device operations): a range recorded on the host is
    mirrored on the device's timeline and is not an operation."""
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type() != cuda]
    ranges = {e.name() for e in host if e.is_user_annotation()} | {STEP}
    dev = [e for e in events if e.device_type() == cuda
           and not e.is_user_annotation() and e.name() not in ranges]
    return host, dev


class Trace:
    """The reduced traces of ``steps`` whole steps; ``timeline`` and
    ``ops`` are the two passes' raw events."""

    def __init__(self, timeline, ops, steps: int):
        self.steps = steps
        host, dev = _split(timeline)
        ranges = [e for e in host if e.name() == STEP]
        if ranges:
            start = min(e.start_ns() for e in ranges)
        else:
            start = min((e.start_ns() for e in dev), default=0)
        end = max([e.end_ns() for e in ranges + dev] + [start])
        self.span_ns = end - start
        self.device = sorted(((e.start_ns(), e.end_ns(), e.name())
                              for e in dev
                              if e.end_ns() > start and e.duration_ns() > 0))
        self.calls = sorted((e.start_ns(), e.end_ns(), e.name())
                            for e in host
                            if e.name().startswith(_CALL_PREFIXES))
        merged: List[List[int]] = []
        for s, t, _ in self.device:
            s = max(s, start)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_ns = sum(t - s for s, t in merged)
        self.gaps, at = [], start
        for s, t in merged:
            if s > at:
                self.gaps.append((at, s))
            at = max(at, t)
        if end > at:
            self.gaps.append((at, end))
        self._ops = _split(ops)

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    @property
    def span_s(self) -> float:
        return self.span_ns / 1e9

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for s, t, name in self.device:
            out[name] += (t - s) / 1e9
        return dict(out)

    def seconds_under(self, ops: Iterable[str]) -> Optional[float]:
        """Device seconds, in the attribution pass, of the kernels launched
        inside host operations named in ``ops``; None where no kernel could
        be tied to any."""
        host, dev = self._ops
        ops = set(ops)
        spans = collections.defaultdict(list)
        for e in host:
            if e.name() in ops:
                spans[e.start_thread_id()].append((e.start_ns(), e.end_ns()))
        for v in spans.values():
            v.sort()
        starts = {k: [s for s, _ in v] for k, v in spans.items()}
        launch = {e.correlation_id(): e for e in host
                  if e.name().startswith(_CALL_PREFIXES)}
        total, tied = 0, 0
        for e in dev:
            call = launch.get(e.correlation_id())
            if call is None or call.start_thread_id() not in spans:
                continue
            thread = call.start_thread_id()
            i = bisect.bisect_right(starts[thread], call.start_ns()) - 1
            if i >= 0 and call.start_ns() <= spans[thread][i][1]:
                total += e.duration_ns()
                tied += 1
        return total / 1e9 if tied else None

    def _gap_name(self, a: int, b: int) -> str:
        """The host's CUDA call in flight at ``a`` -> the kernel at ``b``."""
        i = bisect.bisect_right(self.calls, (a, float("inf"), "")) - 1
        call = self.calls[i][2] if i >= 0 and self.calls[i][1] >= a \
            else "host"
        j = bisect.bisect_left(self.device, (b, -1, ""))
        after = self.device[j][2][:80] if j < len(self.device) else "end"
        return f"{call} -> {after}"

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops[:top]],
                "idle_gaps": [[self._gap_name(a, b), (b - a) / 1e9]
                              for a, b in gaps]}


def trace_steps(step: Callable[[int], None], steps: int,
                sync: Callable[[], None]) -> Trace:
    """Runs ``step(i)`` for ``i < 2 * steps``, each inside a ``bench.step``
    range: the first ``steps`` under the timeline pass, the rest under the
    attribution pass, each pass ending in ``sync()``."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    passes = ([ProfilerActivity.CUDA] if card else [ProfilerActivity.CPU],
              [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                        else []))
    events = []
    for k, acts in enumerate(passes):
        sync()
        with profile(activities=acts) as prof:
            for i in range(k * steps, (k + 1) * steps):
                with record_function(STEP):
                    step(i)
            sync()
        events.append(prof.profiler.kineto_results.events())
    return Trace(events[0], events[1], steps)
