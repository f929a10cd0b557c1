"""The port's measuring tools on the CPU, at ``ULTRA_TINY_MODEL_CONFIG``.

The bench and the forward-mode probe with ``--device cpu`` (their JSON
lines, min <= median <= max, the cumulative last line, the deadline between
phases), the bench's FLOP count against a hand count of one Swin block's
matrix products, the parts profile's decomposition (each part alone
reproduces what it computed inside the forward, and the coarse parts chained
reproduce the forward bit for bit; every part of the JAX tool has its
counterpart), the graft entry against the module's forward, and the timing
helpers ``chip_smoke.py`` imports. Times from these runs are the CPU's and
are not checked.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from strajnet_tpu_torch.config import TINY_MODEL_CONFIG as TINY
from strajnet_tpu_torch.config import ULTRA_TINY_MODEL_CONFIG as CFG
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params
from strajnet_tpu_torch.models.swin import SwinTransformerBlock
from strajnet_tpu_torch.tools import (bench, graft_entry,
                                      probe_forward_modes, profile_parts,
                                      timing)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE_KEYS = {"phase", "batch", "device", "repeats", "iters", "ms",
              "scenes_per_s", "peak_mb", "flops", "mfu", "calls", "launches"}


def _ordered(s):
    return (set(s) == {"min", "median", "max"}
            and s["min"] <= s["median"] <= s["max"]
            and all(np.isfinite(v) for v in s.values()))


@pytest.fixture(scope="module")
def bench_lines():
    lines = []
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "STRAJNET_CONFIG", CFG)
    mp.setattr("builtins.print", lambda line, **kw: lines.append(line))
    try:
        assert bench.main(["--device", "cpu", "--repeats", "2",
                           "--iters", "1"]) == 0
    finally:
        mp.undo()
    return lines


def test_bench_prints_its_device_then_a_line_per_phase(bench_lines):
    assert bench_lines[0].startswith("device cpu; torch ")
    phases = [json.loads(line) for line in bench_lines[1:-1]]
    assert [(p["phase"], p["batch"]) for p in phases] == [
        ("forward", 16), ("train", 16), ("forward", 32)]
    for p in phases:
        assert PHASE_KEYS <= set(p), p
        assert _ordered(p["ms"]) and _ordered(p["scenes_per_s"])
        assert (p["repeats"], p["iters"], p["calls"]) == (2, 1, 2 + 2)
        assert p["flops"] > 0
        # no device metric from a CPU run
        assert p["device"] == "cpu" and p["mfu"] is None
        assert p["peak_mb"] is None
        assert set(p["launches"]) == set(timing.COUNTERS)
        np.testing.assert_allclose(p["scenes_per_s"]["max"],
                                   p["batch"] * 1e3 / p["ms"]["min"])
    assert phases[1]["loss_sum_finite"]
    # twice the batch, twice the FLOPs, but for a few products of the
    # decoder's temporal convolutions and of TrajNet that do not grow with
    # the batch
    assert phases[2]["flops"] == pytest.approx(2 * phases[0]["flops"],
                                               rel=1e-3)


def test_bench_last_line_holds_every_phase(bench_lines):
    last = json.loads(bench_lines[-1])
    assert last["device"] == "cpu" and last["skipped"] == []
    assert list(last["phases"]) == ["forward@16", "train@16", "forward@32"]
    assert list(last["phases"].values()) == [json.loads(line)
                                             for line in bench_lines[1:-1]]


def test_bench_starts_no_phase_after_its_deadline(monkeypatch):
    """With the budget spent, only the headline phase runs."""
    calls = []
    monkeypatch.setattr(bench, "bench_forward",
                        lambda cfg, b, *a: calls.append(b) or {"batch": b})
    monkeypatch.setattr(bench, "bench_train",
                        lambda *a: pytest.fail("training ran"))
    out = bench.run(CFG, "cpu", budget_s=-1.0, emit=lambda line: None)
    assert calls == [16] and list(out["phases"]) == ["forward@16"]
    assert out["skipped"] == ["train@16", "forward@32"]


def test_flop_count_of_one_swin_block_is_its_matrix_products():
    """Stage 0 of ULTRA_TINY: 8 x 8 tokens of C = 8, windows of 4 x 4, one
    head, MLP ratio 2. Per token: qkv 2*C*3C, proj 2*C*C, fc1 and fc2
    2*C*2C each; per token and head, q k^T and P v 2*16*hd each."""
    c, res, ws, ratio, batch = 8, (8, 8), 4, 2.0, 3
    block = SwinTransformerBlock(c, res, 1, ws, ws // 2, ratio,
                                 kernel_mode=False).eval()
    x = torch.randn(batch, res[0] * res[1], c)
    tokens = batch * res[0] * res[1]
    linear = 2 * tokens * c * (3 * c + c + 2 * int(ratio * c))
    attention = 2 * 2 * tokens * ws * ws * c
    with torch.no_grad():
        assert timing.count_flops(lambda: block(x)) == linear + attention


def test_probe_times_every_combination_in_turns(monkeypatch):
    lines = []
    result = probe_forward_modes.run(
        CFG, "cpu", batches=(2,), tails=("xla", "infer"),
        modes=("block", "off"), rounds=2, iters=1, emit=lines.append)
    assert lines[0] == "device cpu"
    assert set(result) == {f"{t}/{m}/2" for t in ("xla", "infer")
                           for m in ("block", "off")}
    for row in result.values():
        assert _ordered(row["ms"]) and _ordered(row["scenes_per_s"])
        # CPU tensors take the plain versions: no kernel launches
        assert row["launches_per_forward"] == dict(k1=0, k3=0, k7=0)
    assert json.loads(lines[-1])["combinations"] == result
    with pytest.raises(ValueError):
        probe_forward_modes.run(CFG, "cpu", tails=("fused",))


@pytest.fixture(scope="module")
def captured():
    state = init_params(CFG, torch.Generator().manual_seed(0))
    model = bench.load_model(CFG, state, "cpu")
    inputs = bench.model_inputs(CFG, 2, torch.device("cpu"), seed=1)
    calls = profile_parts.capture(model, inputs, profile_parts.PARTS)
    return model, inputs, calls


def _flat(obj):
    return list(profile_parts._tensors(obj))


@pytest.mark.parametrize("part", [p for p in profile_parts.PARTS
                                  if p != "fgmsa_nope"])
def test_each_part_alone_reproduces_what_it_computed_in_the_forward(
        captured, part):
    _, _, calls = captured
    assert calls[part], f"{part} made no call"
    alone = profile_parts.run_part(calls[part])
    for c, out in zip(calls[part], alone):
        for a, b in zip(_flat(out), _flat(c.output), strict=True):
            assert torch.equal(a, b)


def test_fgmsa_nope_skips_only_the_rel_pos_bias():
    """At ``TINY_MODEL_CONFIG``, whose 4 x 4 bottleneck gives the bias more
    than one key to shift (ULTRA_TINY's is 1 x 1)."""
    state = init_params(TINY, torch.Generator().manual_seed(0))
    model = bench.load_model(TINY, state, "cpu")
    calls = profile_parts.capture(model, bench.model_inputs(TINY, 2, "cpu"),
                                  ("fgmsa", "fgmsa_nope"))
    (c,) = calls["fgmsa_nope"]
    assert c.fn is not model.fg_msa_layer and c.fn.use_pe is False
    nope = profile_parts.run_part(calls["fgmsa_nope"])[0]
    (with_pe,) = calls["fgmsa"]
    assert nope[0].shape == with_pe.output[0].shape
    assert not torch.equal(nope[0], with_pe.output[0])
    # the offsets and the flow head do not see the bias
    for a, b in zip(nope[1:], with_pe.output[1:]):
        assert torch.equal(a, b)


def test_chained_coarse_parts_reproduce_the_forward(captured):
    """The forward again, with the encoder, FG-MSA, the fusion and the
    decoder each replaced by its run alone on the inputs it had: the same
    output, bit for bit."""
    model, inputs, calls = captured
    (full,) = calls["full"]
    handles = []
    for part in ("encoder", "fgmsa", "trajnet", "decoder"):
        (c,) = calls[part]
        alone = profile_parts.run_part([c])[0]
        handles.append(c.fn.register_forward_hook(
            lambda m, a, out, alone=alone: alone))
    try:
        with torch.inference_mode():
            chained = model(**inputs)
    finally:
        for h in handles:
            h.remove()
    assert torch.equal(chained, full.output)


def test_every_jax_part_has_its_counterpart():
    """The JAX tool's ``_KNOWN_PARTS`` (read from its source: importing it
    runs it), all ported; none is left out."""
    with open(os.path.join(REPO, "tools", "profile_parts.py")) as f:
        tree = ast.parse(f.read())
    known = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "_KNOWN_PARTS")
    assert set(profile_parts.PARTS) == known
    assert profile_parts.COARSE == ("full", "encoder", "fgmsa", "trajnet",
                                    "decoder")


def test_parts_profile_reports_every_part(capsys):
    result = profile_parts.run(CFG, "cpu", 2, 1, profile_parts.PARTS)
    assert set(result) == set(profile_parts.PARTS)
    for part, row in result.items():
        assert row["ms"] > 0 and row["bytes_in"] > 0 and row["bytes_out"] > 0
        assert row["device_ms"] is None and row["tflops"] is None, part
        assert row["peak_flops_share"] is None, part
    assert result["full"]["flops"] == sum(
        result[p]["flops"] for p in ("encoder", "fgmsa", "trajnet",
                                     "decoder"))
    assert "beside full" in capsys.readouterr().out


def test_unknown_part_exits_before_any_model_is_built(monkeypatch):
    monkeypatch.setattr(profile_parts, "init_params",
                        lambda *a: pytest.fail("a model was built"))
    with pytest.raises(SystemExit) as e:
        profile_parts.main(["full", "decoder_x", "--device", "cpu"])
    assert e.value.code == 2


def test_graft_entry_equals_the_module_forward(monkeypatch):
    monkeypatch.setattr(graft_entry, "STRAJNET_CONFIG", CFG)
    forward, args = graft_entry.entry(device="cpu")
    params = args[0]
    assert all(v.device.type == "cpu" for v in params.values())
    model = STrajNet(CFG)
    model.load_state_dict(params)
    with torch.inference_mode():
        got = forward(*args)
        want = model.eval()(*args[1:])
    oh, ow = CFG.output_size
    assert got.shape == (1, oh, ow, 4 * CFG.num_waypoints)
    assert torch.equal(got, want)


def test_timing_helpers():
    assert timing.bound(989e12, 0.0) == (1e3, "operations")
    assert timing.bound(0.0, 3.35e12) == (1e3, "bytes")
    assert timing.spread([3.0, 1.0, 2.0, 5.0]) == {
        "min": 1.0, "median": 2.5, "max": 5.0}
    timing.reset_counters()
    assert timing.read_counters() == (0,) * 7
    before = timing.read_counters()
    timing.COUNTERS["k3"].launches += 2
    assert timing.launches_since(before) == {
        f"k{i}": 2 * (i == 3) for i in range(1, 8)}
    assert timing.read_counters() == (0, 0, 2, 0, 0, 0, 0)
    timing.reset_counters()
