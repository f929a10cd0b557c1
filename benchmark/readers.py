"""What the per-layer metrics' readers (``benchmark/metrics/*.py``) share.

Each reader takes a :class:`~benchmark.harness.Reading` and returns its
number, or None where the run holds nothing to read (the harness then
leaves the metric out of the line).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

from benchmark import work
from benchmark.harness import Reading


def mfu(r: Reading) -> Optional[float]:
    """The whole step's FLOPs times the window's steps, over the window
    and the card's bf16 peak, in %."""
    if not r.steps or not r.flops_per_step:
        return None
    return (100.0 * r.flops_per_step * r.steps / r.window_s
            / work.PEAK_FLOPS)


def idle_share(r: Reading) -> Optional[float]:
    """The share of the measured window in which nothing ran on the card,
    in %: one minus the device's busy time a step, the union of the traced
    steps' kernel, copy and set intervals over their number, times the
    window's steps, over the window. The busy time comes from the trace,
    which does not lengthen the kernels; the pace from the untraced window,
    since the profiler's own host work slows a step that the host paces."""
    if r.trace is None or not r.trace.busy_ns or not r.steps:
        return None
    busy = r.trace.busy_s / r.trace.steps
    return 100.0 * (1.0 - busy * r.steps / r.window_s)


def roofline(r: Reading, ops: Iterable[str],
             count: Callable[[dict, int], Tuple[float, float]]
             ) -> Optional[float]:
    """The least time of a layer's work per step over the device time of
    the kernels launched inside the host operations ``ops``, in %."""
    if r.trace is None:
        return None
    seconds = r.trace.seconds_under(ops)
    if not seconds:
        return None
    flops, nbytes = count(r.model, r.batch)
    return 100.0 * work.bound_s(flops, nbytes) * r.trace.steps / seconds
