"""The readers of the program's spans (``benchmark/spans.py``) on hand-built
traces: device time charged to the span around the launch, or through a
backward node to the span of its forward operation, or to none; idle gaps
split over the spans open during them; a ring that does not match the pass
read as nothing; and every reader of a span metric found by name."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans
from benchmark.harness import Reading
from strajnet_tpu_torch.tracing import Span

METRICS = [m["name"] for m in harness.load_spec()["per_layer"]
           if m["name"].split(".")[0] in (
               "host_ms", "host_syncs", "launches")
           or m["name"].split(".")[0].endswith("_ms")]


class Ev:
    """A stand-in for the profiler's ``KinetoEvent``."""

    def __init__(self, name, start, end, thread=1, seq=-1, fwd=0, corr=0,
                 cuda=False):
        self._v = (name, start, end, thread, seq, fwd, corr, cuda)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def start_thread_id(self):
        return self._v[3]

    def sequence_nr(self):
        return self._v[4]

    def fwd_thread_id(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[7]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return False


def _kernel(corr, start, end, name="k"):
    return Ev(name, start, end, thread=0, corr=corr, cuda=True)


def _attribution_trace():
    """A training step on thread 1, its backward on the engine's thread 2;
    a kernel launched in the decoder's span (5 ns), one through a
    convolution's backward node whose forward op sat in the decoder (7 ns),
    one through a ``CopySlices`` node whose number no forward op carries
    (the in-place copy below it sat in the encoder; 3 ns), one launched on
    thread 2 outside any node and one with no launch call (11 and 2 ns,
    charged to no span)."""
    host = [
        Ev("strajnet.train_step", 0, 100),
        Ev("aten::to", 8, 9, seq=5),          # carries the next node's number
        Ev("strajnet.forward", 10, 50),
        Ev("strajnet.encoder", 11, 19),
        Ev("aten::copy_", 12, 13, seq=3),
        Ev("strajnet.decoder", 20, 40),
        Ev("aten::convolution", 30, 31, seq=5),   # the last to carry it
        Ev("cudaLaunchKernel", 25, 26, corr=7),
        Ev("strajnet.backward", 55, 90),
        Ev("ConvolutionBackward0", 60, 70, thread=2, seq=5, fwd=1),
        Ev("aten::convolution_backward", 61, 69, thread=2),
        Ev("cudaLaunchKernel", 62, 63, thread=2, corr=8),
        Ev("torch::autograd::CopySlices", 71, 74, thread=2, seq=4, fwd=1),
        Ev("cudaLaunchKernel", 72, 73, thread=2, corr=10),
        Ev("cudaLaunchKernel", 80, 81, thread=2, corr=9),
    ]
    dev = [_kernel(7, 100, 105), _kernel(8, 110, 117), _kernel(10, 120, 123),
           _kernel(9, 130, 141), _kernel(99, 150, 152)]
    return SimpleNamespace(_ops=(host, dev), steps=1)


def test_device_time_is_charged_to_the_launching_span():
    got = spans.device_ns(_attribution_trace())
    assert got == {"strajnet.decoder": 5 + 7, "strajnet.encoder": 3,
                   spans.NONE: 11 + 2}


def test_a_pass_without_spans_is_read_as_nothing():
    tr = _attribution_trace()
    host, dev = tr._ops
    tr._ops = ([e for e in host if not e.name().startswith("strajnet.")],
               dev)
    assert spans.device_ns(tr) is None
    r = Reading(model={}, batch=1, trace=tr, steps=1, window_s=1.0,
                flops_per_step=1.0)
    assert spans.layer_ms(r, "decoder") is None


def _ring(step_ends=(100,)):
    """One training step a ``(start, end)``: the step, its forward (10-50 ns
    in), the loss (50-60 ns in)."""
    out = []
    for k, (start, end) in enumerate(step_ends):
        base = len(out)
        out += [Span("strajnet.train_step", start, end, -1, k),
                Span("strajnet.forward", start + 10, start + 50, base, k),
                Span("strajnet.loss", start + 50, start + 60, base, k)]
    return out


def _timeline(steps=1):
    calls = [(20, 21, "cudaLaunchKernel"),
             (30, 45, "cudaStreamSynchronize"),
             (52, 53, "cudaLaunchKernel"),
             (54, 200_054, "cudaLaunchKernel"),  # waits on a full queue
             (300, 301, "cudaLaunchKernel")]    # outside the step
    device = [(25, 40, "k"), (55, 95, "k"), (120, 330, "k")]
    return SimpleNamespace(device=device, calls=calls, steps=steps,
                           gaps=[(40, 55), (95, 120)])


def test_a_gap_is_split_over_the_spans_open_during_it():
    tr = _timeline()
    steps, inner = spans.timeline_steps(tr, _ring([(0, 100)]), "train")
    assert [s.name for s in steps] == ["strajnet.train_step"]
    assert len(inner) == 3
    got = spans.idle_ns(tr, inner)
    # 40-50 in the forward, 50-55 in the loss; 95-100 in the step's own
    # time, 100-120 outside every span
    assert got == {"strajnet.forward": 10, "strajnet.loss": 5,
                   "strajnet.train_step": 5, spans.NONE: 20}
    assert sum(got.values()) == sum(b - a for a, b in tr.gaps)


def test_host_time_syncs_and_launches_of_the_steps():
    tr = _timeline()
    steps, _ = spans.timeline_steps(tr, _ring([(0, 100)]), "train")
    # 100 ns less the sync (15) and the long launch's part inside (46)
    assert spans.host_ns(tr, steps) == 100 - 15 - 46
    assert spans.calls_in(tr, steps, spans.is_sync) == 1
    assert spans.calls_in(tr, steps, spans.is_launch) == 3
    assert spans.is_sync("cudaMemcpy") and spans.is_sync(
        "cudaDeviceSynchronize")
    assert not spans.is_sync("cudaMemcpyAsync")


@pytest.mark.parametrize("ring,steps", [
    (_ring([(0, 100)]), 2),            # one step span, two traced steps
    (_ring([(0, 100), (200, 290)]), 2),   # the second holds no CUDA call
    ([], 1),
])
def test_a_ring_that_does_not_match_the_pass_is_read_as_nothing(ring, steps):
    assert spans.timeline_steps(_timeline(steps), ring, "train") is None


def test_the_attribution_passs_steps_are_left_out():
    """Step spans that start after the pass's last device operation are the
    attribution pass's."""
    ring = _ring([(0, 100), (400, 500)])
    steps, inner = spans.timeline_steps(_timeline(), ring, "train")
    assert len(steps) == 1 and {s.step for s in inner} == {0}


def test_the_span_metrics_are_23():
    assert len(METRICS) == 23


@pytest.mark.parametrize("name", METRICS)
def test_every_reader_is_found_and_reads_a_hand_built_run(name, monkeypatch):
    read = harness.load_reader(name)
    none = Reading(model={}, batch=1, trace=None, steps=1, window_s=1.0,
                   flops_per_step=1.0)
    assert read(none) is None
    kind = "infer" if name.endswith(".infer") else "train"
    ring = _ring([(0, 100)])
    if kind == "infer":
        ring = [s._replace(name="strajnet.predict_step")
                if s.name == "strajnet.train_step" else s for s in ring]
    tr = _timeline()
    tr._ops = _attribution_trace()._ops
    monkeypatch.setattr(spans, "ring", lambda: ring)
    r = Reading(model={}, batch=1, trace=tr, steps=1, window_s=1.0,
                flops_per_step=1.0)
    value = read(r)
    assert value is not None and value >= 0
    monkeypatch.setattr(spans, "ring", lambda: None)
    if not name.split(".")[0].endswith("_ms") or "idle" in name \
            or name.startswith("host_ms"):
        assert read(r) is None
