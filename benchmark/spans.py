"""What the readers of the program's spans share.

The program marks the parts of its steps with named spans
(``strajnet_tpu_torch/tracing.py``): ``strajnet.train_step`` around
``strajnet.forward``, ``strajnet.loss``, ``strajnet.backward`` and
``strajnet.optimizer``; ``strajnet.predict_step`` around
``strajnet.forward``; inside the forward ``strajnet.encoder``,
``strajnet.fg_msa``, ``strajnet.trajnet`` and ``strajnet.decoder``. While a
profiler runs, each span is a host operation of the profiler's trace and a
record in the program's ring, on the clock of the profiler's events. The
readers hold them against the traced run's two passes
(``benchmark/trace.py``):

- the timeline pass records no host operation, so its spans come from the
  ring: the step spans that start before the pass's last device operation,
  one a traced step, each around at least one of the pass's CUDA calls
  (else the clocks disagree and nothing is read), and every span of those
  steps. From them: the host's time a step outside its waiting CUDA calls,
  the synchronising calls and the launches a step, and the card's idle time
  split over the innermost spans open during each gap;
- the attribution pass records the host's operations, the spans among them:
  each device operation (kernel, copy, set) is charged to the innermost span
  around its launch call on the call's thread; where there is none (a launch
  from the autograd engine's thread), to the span around the forward
  operation of the backward node around the call, the one of the node's
  ``(fwd_thread_id, sequence_nr)`` (``forward_span``); else to no span
  (``""``).

Where the program keeps no spans (a checkout from before them), or the
trace holds no device operation, every reader returns None.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "strajnet."
STEP = {"train": "strajnet.train_step", "infer": "strajnet.predict_step"}
# the metrics' names of the spans
SPAN = {"encoder": "strajnet.encoder", "fgmsa": "strajnet.fg_msa",
        "trajnet": "strajnet.trajnet", "decoder": "strajnet.decoder",
        "loss": "strajnet.loss", "backward": "strajnet.backward",
        "optimizer": "strajnet.optimizer"}
NONE = ""                       # device time of no span, idle time outside
LONG_LAUNCH_NS = 100_000        # a launch that waited for room in the queue
_CALLS = ("cuda", "cu")
_LAUNCHES = ("cudaLaunch", "cuLaunch")


def ring() -> Optional[list]:
    """The program's span records, or None where the program has none."""
    try:
        from strajnet_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def is_sync(name: str) -> bool:
    """A CUDA call that waits for the card: a synchronise, a synchronous
    copy."""
    return "Synchronize" in name or (
        name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name)


def is_launch(name: str) -> bool:
    return name.startswith(_LAUNCHES)


def timeline_steps(trace, records, kind: str):
    """(the timeline pass's step spans, every span of those steps), or None
    where they are not one a traced step, each around one of the pass's
    CUDA calls."""
    if trace is None or not records or not trace.device:
        return None
    last = max(t for _, t, _ in trace.device)
    steps = [s for s in records if s.name == STEP[kind] and s.parent < 0
             and s.end_ns >= 0 and s.start_ns < last]
    if len(steps) != trace.steps:
        return None
    starts = [c[0] for c in trace.calls]
    for s in steps:
        i = bisect.bisect_left(starts, s.start_ns)
        if i == len(starts) or starts[i] >= s.end_ns:
            return None
    ids = {s.step for s in steps}
    return steps, [s for s in records if s.step in ids and s.end_ns >= 0]


def _union(intervals: List[Tuple[int, int]]) -> int:
    total, at = 0, None
    for a, b in sorted(intervals):
        if at is None or a > at:
            total += b - a
            at = b
        elif b > at:
            total += b - at
            at = b
    return total


def host_ns(trace, steps) -> int:
    """The steps' time outside their waiting CUDA calls (synchronises,
    synchronous copies, launches over ``LONG_LAUNCH_NS``), summed."""
    total = 0
    for s in steps:
        waits = [(max(a, s.start_ns), min(b, s.end_ns))
                 for a, b, name in trace.calls
                 if a < s.end_ns and b > s.start_ns
                 and (is_sync(name)
                      or (is_launch(name) and b - a > LONG_LAUNCH_NS))]
        total += s.end_ns - s.start_ns - _union(waits)
    return total


def calls_in(trace, steps, which) -> int:
    """The CUDA calls that ``which(name)`` picks, started inside the
    steps."""
    return sum(1 for a, _, name in trace.calls if which(name)
               and any(s.start_ns <= a < s.end_ns for s in steps))


def _innermost(intervals: Sequence[tuple], points: Sequence[int]) -> list:
    """For each point, the payload of the innermost of the nested
    ``(start, end, payload)`` intervals that holds it, or None."""
    ivs = sorted(intervals, key=lambda v: (v[0], -v[1]))
    out = [None] * len(points)
    stack, j = [], 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        t = points[k]
        while j < len(ivs) and ivs[j][0] <= t:
            while stack and stack[-1][1] < ivs[j][0]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def idle_ns(trace, spans) -> Dict[str, int]:
    """The timeline pass's idle gaps split over the innermost spans open
    during them, by overlap: {span name: ns}, ``NONE`` outside every
    span."""
    cuts = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    segs = []
    for a, b in zip(cuts, cuts[1:]):
        inner = None
        for s in spans:     # in open order: the last opened is innermost
            if s.start_ns <= a and s.end_ns >= b:
                inner = s.name
        if inner is not None:
            segs.append((a, b, inner))
    starts = [a for a, _, _ in segs]
    out: Dict[str, int] = collections.defaultdict(int)
    for a, b in trace.gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s, e, name = segs[i]
            over = min(b, e) - max(a, s)
            if over > 0:
                out[name] += over
                covered += over
            i += 1
        out[NONE] += b - a - covered
    return dict(out)


def forward_span(forward, node) -> Optional[str]:
    """The span of a backward node's forward operation: the one of the
    node's sequence number on its forward thread, or, for the nodes that no
    forward operation records (``CopySlices``, ``AsStridedBackward0``, made
    inside an in-place operation on a view), the one of the nearest number
    below it, the in-place operation's. ``forward``: {thread: (sorted
    sequence numbers, spans)}."""
    seqs, names = forward.get(node.fwd_thread_id(), ((), ()))
    i = bisect.bisect_right(seqs, node.sequence_nr()) - 1
    return names[i] if i >= 0 else None


_memo: Dict[int, tuple] = {}


def device_ns(trace) -> Optional[Dict[str, int]]:
    """The attribution pass's device time charged to each span (module
    docstring): {span name: ns}, ``NONE`` for what no span takes; None
    where the pass holds no span or no device operation."""
    if trace is None:
        return None
    hit = _memo.get(id(trace))
    if hit is not None and hit[0] is trace:
        return hit[1]
    host, dev = trace._ops
    spans = collections.defaultdict(list)
    nodes = collections.defaultdict(list)
    for e in host:
        if e.name().startswith(PREFIX):
            spans[e.start_thread_id()].append(
                (e.start_ns(), e.end_ns(), e.name()))
        elif e.sequence_nr() >= 0:
            nodes[e.start_thread_id()].append(
                (e.start_ns(), e.end_ns(), e))
    out = None
    if spans and dev:
        # a thread's forward operations: (sequence numbers, their spans);
        # an operation carries the number the next node will take, so a
        # node's own is the last to carry its number
        forward = {}
        for thread, ops in nodes.items():
            last = {}
            for start, _, e in sorted(ops, key=lambda v: v[0]):
                if e.fwd_thread_id() == 0:
                    last[e.sequence_nr()] = start
            seqs = sorted(last)
            forward[thread] = (seqs, _innermost(
                spans[thread], [last[q] for q in seqs]))
        calls = {e.correlation_id(): e for e in host
                 if e.name().startswith(_CALLS)}
        tied = collections.defaultdict(list)
        out = collections.defaultdict(int)
        for e in dev:
            call = calls.get(e.correlation_id())
            if call is None:
                out[NONE] += e.duration_ns()
            else:
                tied[call.start_thread_id()].append((call.start_ns(), e))
        for thread, ops in tied.items():
            at = [t for t, _ in ops]
            names = _innermost(spans.get(thread, []), at)
            backward = _innermost([v for v in nodes.get(thread, [])
                                   if v[2].fwd_thread_id() != 0], at)
            for (_, e), name, node in zip(ops, names, backward):
                if name is None and node is not None:
                    name = forward_span(forward, node)
                out[name or NONE] += e.duration_ns()
        out = dict(out)
    _memo.clear()
    _memo[id(trace)] = (trace, out)
    return out


# the readers, per traced step


def _timeline_reading(r, kind: str, count) -> Optional[float]:
    got = timeline_steps(r.trace, ring(), kind)
    if got is None:
        return None
    return count(r.trace, *got) / r.trace.steps


def host_ms(r, kind: str) -> Optional[float]:
    return _timeline_reading(
        r, kind, lambda tr, steps, _: host_ns(tr, steps) / 1e6)


def host_syncs(r, kind: str) -> Optional[float]:
    return _timeline_reading(
        r, kind, lambda tr, steps, _: calls_in(tr, steps, is_sync))


def launches(r, kind: str) -> Optional[float]:
    return _timeline_reading(
        r, kind, lambda tr, steps, _: calls_in(tr, steps, is_launch))


def idle_ms(r, phase: str) -> Optional[float]:
    """The card's idle time a training step put down to ``phase``'s
    span."""
    return _timeline_reading(
        r, "train", lambda tr, _, spans: idle_ns(tr, spans).get(
            SPAN[phase], 0) / 1e6)


def layer_ms(r, layer: str) -> Optional[float]:
    """The device time a step of the work charged to ``layer``'s span."""
    got = device_ns(r.trace)
    if got is None:
        return None
    return got.get(SPAN[layer], 0) / r.trace.steps / 1e6
