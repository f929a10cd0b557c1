"""BENCHMARK.json against the benchmark's files and the contract's forms:
every name found by name, the allowed characters, and a cell,
configuration, traffic mix and per-layer metric added by files alone."""

import json
import re
import shutil

import pytest
import torch

from benchmark import harness
from benchmark import run as bench_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.load_spec()


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
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    from benchmark.tests.conftest import TINY, INFER
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
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file() and "new" not in p.name
              and "tiny" not in p.name and "batches" not in p.name}
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
