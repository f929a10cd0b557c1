"""The check that decides ``correct`` fails what it must fail, at a size a
test run holds: each cell's configuration at TINY's widths, its traffic at
a small batch, its own limits.

- a sound run is correct;
- with the timed path broken underneath (a step that returns its state
  unchanged, half of each batch left out, one scene's outputs altered where
  the model produces them, the Swin blocks' relative-position bias or
  LayerNorm scales left out) the whole run, the harness's look for a chip
  skipped, comes out not correct;
- the control, the reference in the precision below the configuration's
  put in the program's place, reads above a limit, and so does the
  training reference with half of each batch left out of the forward and
  the loss, or of the loss alone.
"""

import functools
import importlib
import json
import shutil

import pytest
import torch

from benchmark import faults, harness
from benchmark import run as bench_run
from benchmark.reference.prec import control_for
from benchmark.tests.conftest import TINY

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAIN_CELLS = [w["name"] for w in SPEC["workloads"]
               if harness.load_json("traffic", w["traffic"])["kind"] == "train"]
FAULTS = {"train": ["unchanged", "half", "altered", *faults.WEIGHT_FAULTS],
          "infer": ["half", "altered", *faults.WEIGHT_FAULTS]}
SMALL = {"train": {"batch": 4}, "infer": {"batch": 4, "ref_rows": 2}}


def _tiny_checkout(tmp_path, cell):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    w = harness.find_cell(SPEC, cell)
    cfg_entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    cfg = json.loads((harness.ROOT / cfg_entry["file"]).read_text())
    cfg["model"].update(TINY)
    (root / cfg_entry["file"]).write_text(json.dumps(cfg))
    path = root / "benchmark" / "traffic" / f"{w['traffic']}.json"
    traffic = json.loads(path.read_text())
    traffic.update(SMALL[traffic["kind"]])
    path.write_text(json.dumps(traffic))
    return root, traffic["kind"]


def _run(root, cell, fault=None):
    args = bench_run.parse(["--workload", cell, "--seed", "3000000019",
                            "--seconds", "0.3"])
    return bench_run.run_cell(SPEC, args, torch.device("cpu"), 0.0,
                              fault=fault, root=root)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_pass_and_planted_faults_fail(tmp_path, cell):
    root, kind = _tiny_checkout(tmp_path, cell)
    line = _run(root, cell)
    assert line["correct"], line["checks"]
    for fault in FAULTS[kind]:
        line = _run(root, cell, fault)
        assert not line["correct"], (fault, line["checks"])


@functools.lru_cache(maxsize=None)
def _calibrated(cell):
    """The cell's calibration readings on one seed at TINY, with its own
    limits, and its kind."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        from pathlib import Path
        root, kind = _tiny_checkout(Path(tmp), cell)
        args = bench_run.parse(["--workload", cell, "--seed", "3000000023",
                                "--seconds", "0.3"])
        ctx = bench_run.context(SPEC, args, torch.device("cpu"), 0.0,
                                root=root)
        module = importlib.import_module(f"benchmark.kinds.{kind}")
        prec = control_for(ctx.model["dtype"])
        return module.calibrate(ctx, [prec]), ctx.limits, prec.name


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    got, limits, control = _calibrated(cell)
    assert harness.judge(got["program"], limits), got["program"]
    assert not harness.judge(got[control], limits), got[control]


@pytest.mark.parametrize("fault", faults.BATCH_FAULTS)
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_the_reference_with_a_batch_fault_fails(cell, fault):
    got, limits, _ = _calibrated(cell)
    assert not harness.judge(got[fault], limits), got[fault]
