"""The port's spans (``strajnet_tpu_torch/tracing.py``) on the CPU, at the
TINY configuration: nothing recorded without a profiler, steps bit-equal with
and without one, the span tree of the training and predict steps in the ring
and in the profiler's events on one clock, and the backward nodes tied back
to the forward spans by ``(fwd_thread_id, sequence_nr)``."""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from strajnet_tpu_torch import tracing
from strajnet_tpu_torch.config import (TINY_MODEL_CONFIG, WAYMO_TASK_CONFIG,
                                       LossConfig, TrainConfig)
from strajnet_tpu_torch.data.synthetic import synthetic_batch
from strajnet_tpu_torch.train.state import create_train_state
from strajnet_tpu_torch.train.step import make_predict_step, make_train_step

torch.set_num_threads(2)
CFG = TINY_MODEL_CONFIG
MODEL = ("strajnet.encoder", "strajnet.fg_msa", "strajnet.trajnet",
         "strajnet.decoder")
TRAIN_TREE = {"strajnet.train_step": None,
              "strajnet.forward": "strajnet.train_step",
              "strajnet.loss": "strajnet.train_step",
              "strajnet.backward": "strajnet.train_step",
              "strajnet.optimizer": "strajnet.train_step",
              **{m: "strajnet.forward" for m in MODEL}}
PREDICT_TREE = {"strajnet.predict_step": None,
                "strajnet.forward": "strajnet.predict_step",
                **{m: "strajnet.forward" for m in MODEL}}


def _batch(seed):
    return {k: torch.from_numpy(v)
            for k, v in synthetic_batch(CFG, 2, seed=seed).items()}


def _run(profiled: bool, steps: int = 2):
    """``steps`` training steps in training mode (dropout drawn) and a
    predict step, from the same seeds: (losses, first forward's outputs,
    parameters, predictions, the profiler's events or None)."""
    state = create_train_state(CFG, TrainConfig(seed=3), device="cpu")
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), CFG.num_waypoints)
    predict = make_predict_step(CFG.num_waypoints)
    gen = torch.Generator().manual_seed(11)
    outs = []
    hook = state.model.register_forward_hook(
        lambda _, __, out: outs.append(out.detach().clone()))
    tracing.clear()
    ctx = (profile(activities=[ProfilerActivity.CPU]) if profiled
           else contextlib.nullcontext())
    with ctx as prof:
        losses = [step(state, _batch(i), gen)[1] for i in range(steps)]
        state.model.eval()
        pred = predict(state.model, _batch(7))
    hook.remove()
    events = prof.profiler.kineto_results.events() if profiled else None
    return (losses, outs[0], [p.detach().clone()
                              for p in state.model.parameters()],
            pred, events)


@pytest.fixture(scope="module")
def profiled():
    got = _run(True)
    return got, tracing.spans()


def test_without_a_profiler_nothing_is_recorded():
    tracing.clear()
    assert tracing.span("strajnet.x") is tracing.span("strajnet.y")
    with tracing.span("strajnet.x"):
        pass
    *_, events = _run(False, steps=1)
    assert events is None and tracing.spans() == []


def test_steps_are_bit_equal_with_and_without_a_profiler(profiled):
    (losses, out, params, pred, _), _ = profiled
    losses0, out0, params0, pred0, _ = _run(False)
    for a, b in zip(losses, losses0):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(out, out0)
    assert all(torch.equal(p, q) for p, q in zip(params, params0))
    for a, b in zip(pred, pred0):
        assert torch.equal(a, b)


def test_the_ring_holds_the_steps_span_trees(profiled):
    (*_, events), ring = profiled
    steps = collections.defaultdict(list)
    for s in ring:
        assert s.end_ns >= s.start_ns
        steps[s.step].append(s)
    assert len(steps) == 3                     # two training steps, a predict
    for k, tree in zip(sorted(steps), [TRAIN_TREE, TRAIN_TREE, PREDICT_TREE]):
        spans = steps[k]
        assert sorted(s.name for s in spans) == sorted(tree)
        for s in spans:
            parent = ring[s.parent].name if s.parent >= 0 else None
            assert parent == tree[s.name], s
            if s.parent >= 0:
                p = ring[s.parent]
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    names = collections.Counter(e.name() for e in events
                                if e.name().startswith("strajnet."))
    assert names == collections.Counter(s.name for s in ring)


def test_ring_and_profiler_events_share_a_clock(profiled):
    (*_, events), ring = profiled
    got = collections.defaultdict(list)
    for e in sorted(events, key=lambda e: e.start_ns()):
        if e.name().startswith("strajnet."):
            got[e.name()].append(e)
    want = collections.defaultdict(list)
    for s in ring:
        want[s.name].append(s)
    for name, spans in want.items():
        assert len(spans) == len(got[name])
        for s, e in zip(spans, got[name]):
            assert abs(s.start_ns - e.start_ns()) < 1_000_000, name
            assert abs(s.end_ns - e.end_ns()) < 1_000_000, name
            assert not e.is_user_annotation()


def test_backward_nodes_link_to_forward_ops_inside_the_model_spans(profiled):
    """Each backward node of the training steps ties to the forward
    operation of the same ``(fwd_thread_id, sequence_nr)``, the last to carry
    the number, inside a span of the model or the loss; the nodes that no forward operation records (made inside
    an in-place operation on a view) tie to the nearest number below
    theirs, the in-place operation's."""
    (*_, events), _ = profiled
    spans = [(e.start_thread_id(), e.start_ns(), e.end_ns(), e.name())
             for e in events if e.name().startswith("strajnet.")]

    def innermost(thread, t):
        inside = [s for s in spans
                  if s[0] == thread and s[1] <= t <= s[2]]
        return max(inside, key=lambda s: s[1])[3] if inside else None

    forward = {}             # an operation carries the number the next
    for e in sorted(events, key=lambda e: e.start_ns()):   # node will take
        if e.sequence_nr() >= 0 and e.fwd_thread_id() == 0 \
                and not e.name().startswith("strajnet."):
            forward[(e.start_thread_id(), e.sequence_nr())] = innermost(
                e.start_thread_id(), e.start_ns())
    nodes = [e for e in events if e.sequence_nr() >= 0
             and e.fwd_thread_id() != 0
             and not e.name().startswith("autograd::engine")]
    assert len(nodes) > 50
    linked, below = collections.Counter(), collections.Counter()
    for e in nodes:
        key = (e.fwd_thread_id(), e.sequence_nr())
        if key not in forward:
            below[e.name()] += 1
            key = max(k for k in forward if k[0] == key[0] and k < key)
        where = forward[key]
        assert where in MODEL + ("strajnet.loss",), (e.name(), where)
        linked[where] += 1
    assert set(below) <= {"torch::autograd::CopySlices",
                          "AsStridedBackward0"}
    assert {"strajnet.encoder", "strajnet.trajnet",
            "strajnet.decoder"} <= set(linked)


def test_a_span_whose_parent_left_the_ring_is_outermost(monkeypatch):
    import collections as c
    monkeypatch.setattr(tracing, "_ring", c.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("strajnet.a"):
            for name in ("strajnet.b", "strajnet.c", "strajnet.d"):
                with tracing.span(name):
                    pass
    ring = tracing.spans()
    assert [s.name for s in ring] == ["strajnet.b", "strajnet.c",
                                      "strajnet.d"]
    assert [s.parent for s in ring] == [-1, -1, -1]
    assert len({s.step for s in ring}) == 1
