"""BENCHMARK.json against the benchmark's files and the contract's forms:
every name found by name, the allowed characters; a cell, configuration,
traffic mix and per-layer metric added by files alone, and so a new
architecture with a plain reference of its own; the configurations without
one read as before."""

import json
import math
import re
import shutil
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import faults, harness, weights
from benchmark import pool as pools
from benchmark import run as bench_run
from benchmark.flops import step_flops
from benchmark.kinds import infer, train
from benchmark.reference import loss as ref_loss
from benchmark.reference import model as ref_model
from benchmark.tests.conftest import INFER, TINY, TRAIN, port_config

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.load_spec()


def _checkout(tmp_path) -> Path:
    """A copy of the benchmark's files, the tests left out."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def _files(root: Path) -> dict:
    return {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
            if p.is_file()}


def test_every_file_is_found_by_name():
    for cfg in SPEC["configs"]:
        assert cfg["file"].startswith("benchmark/configs/")
        assert harness.find_config(SPEC, cfg["name"])["model"]
    for cell in SPEC["workloads"]:
        traffic = harness.load_json("traffic", cell["traffic"])
        assert (harness.HERE / "kinds" / f"{traffic['kind']}.py").exists()
        assert harness.load_json("cells", cell["name"])["limits"]
    for m in SPEC["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_names_units_and_references():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_new_cell_is_picked_up_by_its_files_alone(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix, cell
    and per-layer metric, each a new file and a new entry: the harness
    finds and runs them with no file of the copy edited."""
    root = _checkout(tmp_path)
    before = _files(root)
    spec = json.loads(json.dumps(SPEC))
    model = dict(harness.find_config(SPEC, "strajnet_fgmsa_bf16")["model"],
                 **TINY, dtype="float32")
    (root / "benchmark/configs/tiny_new.json").write_text(json.dumps(
        {"source": "test", "model": model}))
    (root / "benchmark/traffic/infer_tiny.json").write_text(json.dumps(
        INFER))
    (root / "benchmark/cells/tiny_new.infer_tiny.json").write_text(
        json.dumps({"limits": {"out_gap": 1e-4}}))
    (root / "benchmark/metrics/batches.infer.py").write_text(
        "def read(r):\n    return float(r.steps)\n")
    spec["configs"].append({"name": "tiny_new", "source": "test",
                            "file": "benchmark/configs/tiny_new.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_new.infer_tiny",
                              "config": "tiny_new", "traffic": "infer_tiny",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and m["name"].endswith(".infer") or \
                m["name"] in ("infer_scenes_per_s", "infer_batch_ms_p95"):
            m["workloads"].append("tiny_new.infer_tiny")
    spec["per_layer"].append({"name": "batches.infer", "unit": "batches",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving step",
                              "moves": "infer_scenes_per_s",
                              "workloads": ["tiny_new.infer_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for trace in (0, 1):
        args = bench_run.parse(["--workload", "tiny_new.infer_tiny",
                                "--seed", "5", "--seconds", "0.3",
                                "--trace", str(trace)])
        line, _ = bench_run.run_cell(spec, args, torch.device("cpu"), 0.0,
                                     root=root)
        assert line["correct"], line["checks"]
        if trace:
            assert line["metrics"]["batches.infer"]["value"] >= 1
        else:
            assert set(line["metrics"]) == {"infer_scenes_per_s",
                                            "infer_batch_ms_p95", "peak_gib",
                                            "setup_s"}
        assert list(line)[-1] == "checks"
    for p, data in before.items():
        assert p.read_bytes() == data


# The stand-in architecture of the test below: the frozen reference with
# the Swin encoder's absolute position embedding (``ape``, a wiring that the
# program states and model.py does not) added to the patch grid before its
# LayerNorm, and a weight rule of its own for the embedding.
STAND_IN_EDITS = (
    ("large_input=True, ape=False,", "large_input=True, ape=True,"),
    ("    x = layer_norm(x + maps.reshape(-1, pr * pr, e), p,",
     "    x = layer_norm(x + maps.reshape(-1, pr * pr, e)\n"
     "                   + p[\"encoder.absolute_pos_embed\"], p,"),
)
STAND_IN_RULE = """

def _ape(u, z):
    return 0.5 * torch.clamp(z, -2.0, 2.0)


LEAF_RULES = dict(LEAF_RULES, absolute_pos_embed=_ape)
"""
# float32 on the CPU: the program's plain path is the reference's to
# round-off (test_bench_reference.py's tolerances); a stand-in that ignored
# the embedding reads out_gap 0.16
STAND_IN_LIMITS = {"infer": {"out_gap": 1e-4},
                   "train": {"out_gap": 1e-4, "loss_gap": 1e-5,
                             "grad_gap": 1e-4, "update_gap": 1e-3}}
STAND_IN_METRICS = {"infer": ("infer_scenes_per_s", "infer_batch_ms_p95",
                              "mfu.infer"),
                    "train": ("train_scenes_per_s", "mfu.train")}


def _tiny_spec(model: dict):
    from strajnet_tpu_torch.models.strajnet import STrajNet
    return weights.spec_of(STrajNet(port_config(model)).state_dict())


def test_a_new_architecture_is_picked_up_by_its_files_alone(tmp_path):
    """A copy of the benchmark with a configuration whose file names a
    reference file of its own (the stand-in above), and an infer and a
    train cell of it, each a new file and a new entry: the harness draws
    the new leaf by the stand-in's rule, checks the wiring, compares and
    counts the step's FLOPs by the stand-in, untraced and traced, with no
    file of the copy edited. model.py does not state ``ape`` (its check
    raises), so a correct run was compared and counted by the stand-in."""
    root = _checkout(tmp_path)
    before = _files(root)
    text = (harness.HERE / "reference" / "model.py").read_text()
    for old, new in STAND_IN_EDITS:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    (root / "benchmark/reference/model_ape.py").write_text(
        text + STAND_IN_RULE)
    model = dict(harness.find_config(SPEC, "strajnet_fgmsa_bf16")["model"],
                 **TINY, dtype="float32", ape=True)
    config = {"source": "test", "reference": "model_ape.py", "model": model}
    (root / "benchmark/configs/tiny_ape.json").write_text(json.dumps(config))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tiny_ape", "source": "test",
                            "file": "benchmark/configs/tiny_ape.json",
                            "reduced": [], "why": "test"})
    metrics = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for kind, traffic in (("infer", INFER), ("train", TRAIN)):
        cell = f"tiny_ape.{kind}_tiny"
        (root / f"benchmark/traffic/{kind}_tiny.json").write_text(
            json.dumps(traffic))
        (root / f"benchmark/cells/{cell}.json").write_text(
            json.dumps({"limits": STAND_IN_LIMITS[kind]}))
        spec["workloads"].append({"name": cell, "config": "tiny_ape",
                                  "traffic": f"{kind}_tiny", "chips": 1,
                                  "why": "test"})
        for m in STAND_IN_METRICS[kind]:
            metrics[m]["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for kind in ("infer", "train"):
        for trace in (0, 1):
            args = bench_run.parse(["--workload", f"tiny_ape.{kind}_tiny",
                                    "--seed", "2147483659", "--seconds",
                                    "0.3", "--trace", str(trace)])
            line, _ = bench_run.run_cell(spec, args, torch.device("cpu"),
                                         0.0, root=root)
            assert line["correct"], (kind, trace, line["checks"])
            if trace:
                assert line["metrics"][f"mfu.{kind}"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data

    ref = harness.load_reference(config, root / "benchmark")
    assert Path(ref.__file__) == root / "benchmark/reference/model_ape.py"
    leaves = _tiny_spec(model)
    new = weights.draw(leaves, 11, "cpu", ref.LEAF_RULES)
    old = weights.draw(leaves, 11, "cpu", ref_model.LEAF_RULES)
    assert [k for k in new if not torch.equal(new[k], old[k])] == [
        "encoder.absolute_pos_embed"]
    with pytest.raises(ValueError, match="ape"):
        step_flops(ref_model, model, leaves, 2, False)
    # the embedding is an addition: model.py's products without it
    plain = [s for s in leaves if s[0] != "encoder.absolute_pos_embed"]
    for train in (False, True):
        assert step_flops(ref, model, leaves, 2, train) == step_flops(
            ref_model, dict(model, ape=False), plain, 2, train)


# benchmark/weights.py::draw, benchmark/faults.py::weights_seen and
# benchmark/flops.py::step_flops as they were while the benchmark had one
# reference, pinned: a configuration that names none reads the same
# through the harness.

def _pinned_draw(spec, seed: int, device):
    sizes = [math.prod(s) for _, s in spec]
    total = sum(sizes)
    g = torch.Generator(device).manual_seed(seed)
    uni = torch.rand(total, device=device, generator=g) * 2.0 - 1.0
    nrm = torch.randn(total, device=device, generator=g)
    out, at = {}, 0
    for (name, shape), size in zip(spec, sizes):
        u, z = uni[at:at + size].view(shape), nrm[at:at + size].view(shape)
        at += size
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("bias"):
            t = z * 0.1
        elif leaf in ("relative_position_bias_table", "rpe_table"):
            t = 1.0 * torch.clamp(z, -2.0, 2.0)
        elif len(shape) == 1:
            t = 1.0 + 0.2 * torch.clamp(z, -2.0, 2.0)
        else:
            fan_in, fan_out = weights._fans(shape)
            t = u * math.sqrt(6.0 / (fan_in + fan_out))
        out[name] = t.clone()
    return out


def _pinned_weights_seen(p, fault):
    out = dict(p)
    for k, v in p.items():
        if ".blocks" not in k:
            continue
        if fault == "no_relpos" and k.endswith(
                "relative_position_bias_table"):
            out[k] = torch.zeros_like(v)
        elif fault == "no_ln_scale" and k.endswith(
                ("norm1.weight", "norm2.weight")):
            out[k] = torch.ones_like(v)
    return out


def _pinned_step_flops(model, spec, batch: int, train: bool) -> float:
    cfg = pools.with_sizes(model)
    params = {k: torch.empty(s, device="meta", requires_grad=train)
              for k, s in spec}
    g = torch.Generator().manual_seed(0)
    real = pools.render(cfg, pools.draws(cfg, 1, g, "cpu"), train)
    data = {k: torch.empty((batch,) + tuple(v.shape[1:]), device="meta")
            for k, v in real.items()}
    with FlopCounterMode(display=False) as counter:
        out = ref_model.forward(params, model, data)
        if train:
            total = ref_loss.total(ref_loss.loss_terms(
                data, out, model["num_waypoints"]))
            torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return float(counter.get_total_flops())


def _same(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_the_configurations_read_as_before(name):
    """Each configuration file names no reference and resolves to
    model.py; at TINY's widths its run's weights, both weight faults and
    the step's FLOPs, forward and training, are the pinned functions'."""
    assert "reference" not in harness.find_config(SPEC, name)
    cell = next(w["name"] for w in SPEC["workloads"] if w["config"] == name)
    args = bench_run.parse(["--workload", cell, "--seed", "2147483659",
                            "--seconds", "1"])
    ctx = bench_run.context(SPEC, args, torch.device("cpu"), 0.0)
    assert Path(ctx.reference.__file__) == \
        harness.HERE / "reference" / "model.py"
    model = dict(ctx.model, **TINY)
    leaves = _tiny_spec(model)
    p = ctx.weights(leaves)
    assert _same(p, _pinned_draw(leaves, ctx.seed_of("weights"), "cpu"))
    for fault in faults.WEIGHT_FAULTS:
        seen = faults.weights_seen(p, fault, ctx.reference.FAULT_LEAVES)
        assert _same(seen, _pinned_weights_seen(p, fault))
        assert not _same(seen, p)
    for train in (False, True):
        assert step_flops(ctx.reference, model, leaves, 2, train) == \
            _pinned_step_flops(model, leaves, 2, train)


@pytest.mark.parametrize("reference,wiring,error,named", [
    ("absent.py", {}, FileNotFoundError, "absent.py"),
    ("model.py", {"ape": True}, ValueError, "ape"),
])
def test_a_missing_reference_or_unstated_wiring_fails_before_set_up(
        tmp_path, monkeypatch, reference, wiring, error, named):
    """A configuration that names a reference file the checkout lacks, or
    whose wiring its reference does not state, raises, naming the file or
    the setting, before any set-up."""
    root = _checkout(tmp_path)
    entry = SPEC["configs"][0]
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    config["reference"] = reference
    config["model"].update(wiring)
    (root / entry["file"]).write_text(json.dumps(config))

    def no_set_up(*_, **__):
        pytest.fail("set-up began")

    monkeypatch.setattr(infer.Program, "__init__", no_set_up)
    monkeypatch.setattr(train.Program, "__init__", no_set_up)
    for cell in SPEC["workloads"]:
        if cell["config"] == entry["name"]:
            args = bench_run.parse(["--workload", cell["name"], "--seed",
                                    "1", "--seconds", "1"])
            with pytest.raises(error, match=re.escape(named)):
                bench_run.run_cell(SPEC, args, torch.device("cpu"), 0.0,
                                   root=root)


def test_a_metric_family_reads_its_base_metric():
    """``<metric>.<family>`` is the same number as ``<metric>`` under a
    bound of its own, reported in the cells the family lists."""
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for name, m in e2e.items():
        if "." not in name:
            continue
        base = e2e[name.split(".", 1)[0]]
        assert m["unit"] == base["unit"] and m["better"] == base["better"]
        assert set(m["workloads"]) <= set(base.get("workloads", []))
    args = bench_run.parse(["--workload", "trainpy_f32.infer_b16", "--seed",
                            "1", "--seconds", "1"])
    ctx = bench_run.context(SPEC, args, torch.device("cpu"), 0.0)
    out = {"e2e": {"infer_scenes_per_s": 222.5, "infer_batch_ms_p95": 72.0},
           "setup_s": 15.0, "peak": 2 ** 31, "held": 2 ** 30,
           "attempted": 10, "failed": 0, "readings": {"out_gap": 0.0}}
    metrics = bench_run.result_line(SPEC, ctx, out, "cpu")["metrics"]
    assert metrics["infer_scenes_per_s.f32"]["value"] == 222.5
    assert metrics["infer_batch_ms_p95.f32"]["value"] == 72.0
    assert metrics["peak_gib"]["value"] == 1.0


def test_without_a_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    cell = SPEC["workloads"][0]["name"]
    rc = bench_run.main(["--workload", cell, "--seed", "1", "--seconds",
                         "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
