"""No module that a chip run of the benchmark loads has the top-level name
of JAX, Flax, Optax or the JAX package, compared as a whole name (the
port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

HERE = Path(harness.__file__).parent


def test_whole_names_are_compared():
    assert "strajnet_tpu" in harness.FORBIDDEN
    names = ["strajnet_tpu_torch.models", "strajnet_tpu_torch", "jaxtyping"]
    assert not [m for m in names if m.split(".", 1)[0] in harness.FORBIDDEN]
    assert [m for m in ["strajnet_tpu.models", "jax.numpy"]
            if m.split(".", 1)[0] in harness.FORBIDDEN]


def test_no_source_of_the_run_imports_them():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in harness.FORBIDDEN, (path, m)


def test_a_run_loads_none_of_them():
    """Every module of a run, the program's included, in a fresh process."""
    code = (
        "import sys, torch\n"
        "import benchmark.run, benchmark.kinds.train, benchmark.kinds.infer\n"
        "import benchmark.flops, benchmark.readers\n"
        "from benchmark import harness\n"
        "for m in harness.load_spec()['per_layer']:\n"
        "    harness.load_reader(m['name'])\n"
        "import strajnet_tpu_torch.train.step, strajnet_tpu_torch.train.state\n"
        "import strajnet_tpu_torch.models.strajnet\n"
        "print(','.join(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
