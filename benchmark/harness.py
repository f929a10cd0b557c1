"""What every cell shares: finding its files by name, the run's context,
the per-layer readers, the comparison against the limits and the result
line.

``BENCHMARK.json`` names each cell's configuration and traffic. The harness
finds, by those names alone:

- ``benchmark/configs/<config>.json`` (the configuration's own ``file``
  entry): the model's settings as run, handed to the program's
  ``ModelConfig`` and to the plain reference;
- ``benchmark/reference/<file>.py``, the file that the configuration names
  under ``reference`` (``model.py`` without the key): its plain reference
  (:func:`load_reference`);
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters, among
  them ``kind``, the module ``benchmark/kinds/<kind>.py`` that drives it;
- ``benchmark/cells/<cell>.json``: the cell's correctness limits;
- ``benchmark/metrics/<metric>.py``: each per-layer metric's reader, a
  ``read(reading)`` that returns a number or None.

A new cell, configuration, traffic mix or per-layer metric is a new file
and a new entry in ``BENCHMARK.json``, and a new architecture a new
reference file beside them; no file here changes.
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

from benchmark.weights import draw

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "strajnet_tpu")
REFERENCE = "model.py"    # the reference of a configuration that names none
REFERENCE_NAMES = ("forward", "check_config", "LEAF_RULES", "FAULT_LEAVES")


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


def _load(path: Path, name: str):
    """The module of the file ``path``, under ``name`` in ``sys.modules``
    (where a dataclass of the module looks itself up)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = module
    mod_spec.loader.exec_module(module)
    return module


def load_reader(metric: str, here: Path = HERE) -> Callable:
    return _load(here / "metrics" / f"{metric}.py",
                 f"benchmark.metrics.{metric.replace('.', '_')}").read


def load_reference(config: dict, here: Path = HERE):
    """The plain reference that a configuration file names under
    ``reference``: a file of ``benchmark/reference/``, ``model.py`` where
    the file names none. It states the architecture:

    - ``forward(p, model, batch, prec, generator)``: the outputs of a batch
      from the weights ``p`` (the names of the program's ``state_dict``);
    - ``check_config(model)``: raises on a wiring it does not state;
    - ``LEAF_RULES``: ``{name suffix: rule(u, z)}``, the weights of its own
      leaves (:func:`benchmark.weights.draw`);
    - ``FAULT_LEAVES``: ``{fault: (under, suffixes, value)}``, the leaves
      that each of :mod:`benchmark.faults`' weight faults sets.

    Raises, naming the file, where it is not there or lacks one of them."""
    name = config.get("reference", REFERENCE)
    path = here / "reference" / name
    if Path(name).name != name or path.suffix != ".py" or not path.is_file():
        raise FileNotFoundError(f"the configuration's reference {name!r} is "
                                f"not a .py file of {path.parent}")
    module = _load(path, f"benchmark_reference.{path.stem}")
    missing = [n for n in REFERENCE_NAMES if not hasattr(module, n)]
    if missing:
        raise AttributeError(f"the reference {name!r} does not state "
                             f"{', '.join(missing)}")
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    cell: dict
    model: dict           # the configuration's model settings
    reference: Any        # its plain reference (load_reference)
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

    def weights(self, spec) -> Dict[str, Any]:
        """The run's weights for ``spec``, drawn from its seed by the
        reference's rules: the same on both sides."""
        return draw(spec, self.seed_of("weights"), self.device,
                    self.reference.LEAF_RULES)


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
