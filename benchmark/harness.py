"""What every cell shares: finding its files by name, the run's context,
the per-layer readers, the comparison against the limits and the result
line.

``BENCHMARK.json`` names each cell's configuration and traffic. The harness
finds, by those names alone:

- ``benchmark/configs/<config>.json`` (the configuration's own ``file``
  entry): the model's settings as run, handed to the program's
  ``ModelConfig`` and to the plain reference;
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters, among
  them ``kind``, the module ``benchmark/kinds/<kind>.py`` that drives it;
- ``benchmark/cells/<cell>.json``: the cell's correctness limits;
- ``benchmark/metrics/<metric>.py``: each per-layer metric's reader, a
  ``read(reading)`` that returns a number or None.

A new cell, configuration, traffic mix or per-layer metric is a new file
and a new entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "strajnet_tpu")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def find_config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for cfg in spec["configs"]:
        if cfg["name"] == name:
            return json.loads((root / cfg["file"]).read_text())
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, here: Path = HERE) -> dict:
    return json.loads((here / kind / f"{name}.json").read_text())


def load_reader(metric: str, here: Path = HERE) -> Callable:
    path = here / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    cell: dict
    model: dict           # the configuration's model settings
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float             # host clock at the process's start
    fault: Optional[str] = None   # a planted fault, for the checks' tests
    marks: List = dataclasses.field(default_factory=list)

    def mark(self, label: str) -> None:
        """Notes the host clock, from the process's start, at a point of
        set-up (printed on standard error before the checks)."""
        self.marks.append((label, time.perf_counter() - self.t0))

    def seed_of(self, part: str) -> int:
        """A seed of its own for each part of the run."""
        return (self.seed * 4 + {"data": 0, "weights": 1, "noise": 2,
                                 "sample": 3}[part]) % 2 ** 63


@dataclasses.dataclass
class Reading:
    """What a per-layer reader sees."""

    model: dict
    batch: int
    trace: Any            # benchmark.trace.Trace of the traced steps
    steps: int            # steps in the measured window
    window_s: float
    flops_per_step: float


def ports_config(model: dict):
    """The program's ``ModelConfig`` for the configuration's settings."""
    from strajnet_tpu_torch.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in model.items() if k in fields}
    return ModelConfig(**kw)


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit within it; a missing or non-finite
    number fails, and so does a cell with no limit. The cell's file names
    the numbers compared; the others are only printed."""
    if not limits:
        return False
    return all(k in readings and math.isfinite(readings[k])
               and readings[k] <= v for k, v in limits.items())


def checks_line(readings: Dict[str, float], limits: Dict[str, float]):
    """Each compared number beside its limit (null where it is missing or
    not finite: JSON has no NaN)."""
    def finite(v):
        return v if v is not None and math.isfinite(v) else None

    return {k: {"value": finite(readings.get(k)), "limit": v}
            for k, v in sorted(limits.items())}


def per_layer(spec: dict, cell: str, reading: Reading,
              here: Path = HERE) -> Dict[str, dict]:
    out = {}
    for m in spec["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        value = load_reader(m["name"], here)(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
