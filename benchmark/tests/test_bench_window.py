"""The end-to-end statistics are taken over the whole window and all its
batches: a stall inside the window lowers the rate and, where it is one
batch in twenty or more, sets the 95th percentile."""

import numpy as np
import pytest
import torch

from benchmark import pool as pools
from benchmark.kinds import infer, train
from benchmark.tests.conftest import INFER, TRAIN, tiny_context, tiny_model


class Clock:
    """A host clock that moves only where a step says so."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


def _scripted(monkeypatch, module, durations):
    clock = Clock()
    monkeypatch.setattr(module.time, "perf_counter", clock.perf_counter)
    real = module.Program.call
    calls = []

    def call(self, *a):
        out = real(self, *a)
        clock.now += durations[len(calls) % len(durations)]
        calls.append(1)
        return out

    monkeypatch.setattr(module.Program, "call", call)
    return calls


def test_infer_rate_and_p95_count_every_batch(monkeypatch):
    # one batch in ten stalls: 9 x 10 ms, then 210 ms
    durations = [0.01] * 9 + [0.21]
    calls = _scripted(monkeypatch, infer, durations)
    ctx = tiny_context(tiny_model(dtype="float32"), INFER, seconds=1.0,
                       limits={"out_gap": 1e-4})
    out = infer.run(ctx)
    n = out["steps"]
    window = sum(durations[i % 10] for i in range(4, 4 + n))
    assert out["window_s"] == pytest.approx(window)
    assert out["e2e"]["infer_scenes_per_s"] == pytest.approx(
        n * INFER["batch"] / window)
    times = np.array([durations[i % 10] for i in range(4, 4 + n)]) * 1e3
    assert out["e2e"]["infer_batch_ms_p95"] == pytest.approx(
        np.percentile(times, 95))
    assert out["e2e"]["infer_batch_ms_p95"] > 100.0
    assert len(calls) == 4 + n


def test_train_rate_counts_the_whole_window(monkeypatch):
    durations = [0.05, 0.05, 0.05, 0.5]
    _scripted(monkeypatch, train, durations)
    ctx = tiny_context(tiny_model(dtype="float32"), TRAIN, seconds=1.0,
                       limits={"loss_gap": 1, "grad_gap": 1,
                               "update_gap": 1})
    out = train.run(ctx)
    n = out["steps"]
    window = sum(durations[i % 4] for i in range(3, 3 + n))
    assert out["window_s"] == pytest.approx(window)
    assert out["e2e"]["train_scenes_per_s"] == pytest.approx(
        n * TRAIN["batch"] / window)


def test_pool_paints_what_a_box_by_box_loop_paints():
    cfg = pools.with_sizes(tiny_model())
    g = torch.Generator().manual_seed(12)
    d = pools.draws(cfg, 3, g, "cpu")
    got = pools.render(cfg, d, train=True)
    h, oh, t = cfg["input_size"][0], cfg["output_size"], 8
    box = max(2, oh // 32)
    ogm = np.zeros((3, h, h), np.float32)
    vec = np.zeros((3, h, h, 2), np.float32)
    obs = np.zeros((3, t, oh, oh), np.float32)
    flow = np.zeros((3, t, oh, oh, 2), np.float32)
    origin = np.zeros((3, oh, oh), np.float32)
    for b in range(3):
        for a in range(pools.AGENTS):
            y, x = int(d["y"][b, a]), int(d["x"][b, a])
            vy, vx = int(d["vy"][b, a]), int(d["vx"][b, a])
            cy, cx = (h - oh) // 2 + y, (h - oh) // 2 + x
            ogm[b, cy:cy + box, cx:cx + box] = 1
            vec[b, cy:cy + box, cx:cx + box] = (vx, vy)
            origin[b, y:y + box, x:x + box] = 1
            for k in range(t):
                yy = min(max(y + vy * (k + 1), 0), oh - box)
                xx = min(max(x + vx * (k + 1), 0), oh - box)
                obs[b, k, yy:yy + box, xx:xx + box] = 1
                flow[b, k, yy:yy + box, xx:xx + box] = (-vx, -vy)
    assert np.array_equal(got["ogm"][..., 0].numpy(),
                          np.repeat(ogm[..., None], 11, -1))
    assert not got["ogm"][..., 1].any()
    assert np.array_equal(got["vec_flow"].numpy(), vec)
    assert np.array_equal(got["gt_obs_ogm"][..., 0].numpy(), obs)
    assert np.array_equal(got["gt_flow"].numpy(), flow)
    assert np.array_equal(got["origin_flow"][:, 3, ..., 0].numpy(), origin)
    assert torch.equal(got["actors"][:, :pools.AGENTS], d["actors"])
    assert not got["actors"][:, pools.AGENTS:].any()


def test_idle_share_is_taken_at_the_windows_pace():
    """The device's busy time a step comes from the trace, the pace from
    the untraced window: a traced pass that the profiler slows leaves the
    reading as it is."""
    from types import SimpleNamespace
    from benchmark.harness import Reading
    from benchmark.readers import idle_share
    for span in (0.6, 0.9):                  # the traced pass's own pace
        trace = SimpleNamespace(busy_ns=int(0.45e9), busy_s=0.45, steps=5,
                                span_s=span)
        r = Reading(model={}, batch=16, trace=trace, steps=40,
                    window_s=4.8, flops_per_step=1.0)
        assert idle_share(r) == pytest.approx(100.0 * (1 - 0.09 * 40 / 4.8))
    r = Reading(model={}, batch=16, trace=None, steps=40, window_s=4.8,
                flops_per_step=1.0)
    assert idle_share(r) is None
