"""The port stands alone: it imports nothing of JAX or of the JAX package.

Walks every source file of ``strajnet_tpu_torch``, ``chip_smoke.py`` and the
port's scripts under ``tools/`` with ``ast``; checks that the package imports where neither ``triton`` nor ``nvcc``
exists; that the port's own copies of the framework-free modules still agree
with the JAX package's; and that the entry points run on the card unless told
otherwise.
"""

import ast
import dataclasses
import importlib
import os
import pkgutil
import re
import shutil

import numpy as np
import pytest
import torch

import strajnet_tpu.config as jconfig
import strajnet_tpu_torch
import strajnet_tpu_torch.config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "chex", "strajnet_tpu")
# The port's scripts under tools/, beside the JAX package's.
PORT_SCRIPTS = ("profile_loop_gpu.py", "swin_block_bwd_phases.py")
# Numbers of the TPU and A100 rounds, which are not the port's.
FOREIGN_NUMBERS = ("197e12", "1365e9", "293.0")


def _port_sources():
    root = os.path.join(REPO, "strajnet_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", n) for n in PORT_SCRIPTS]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


def test_no_source_file_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 30
    bad = [(os.path.relpath(path, REPO), line, name)
           for path in files for name, line in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("path", [os.path.relpath(p, REPO)
                                  for p in _port_sources()])
def test_file_imports_only_the_port_torch_numpy_and_stdlib(path):
    """Per file: beyond the standard library, only torch, numpy, the port
    itself and (lazily, to read real shards) tensorflow; the map raster
    also (lazily) matplotlib, which draws it; the Keras import also (lazily)
    tf_keras, which builds the reference model; the scripts under ``tools/``
    also ``chip_smoke``, whose helpers they share."""
    import sys
    allowed = {"torch", "numpy", "strajnet_tpu_torch", "tensorflow"}
    if path == os.path.join("strajnet_tpu_torch", "data", "map_raster.py"):
        allowed.add("matplotlib")
    if path in (os.path.join("strajnet_tpu_torch", "interop", "refload.py"),
                os.path.join("strajnet_tpu_torch", "interop",
                             "ref_import.py")):
        allowed.add("tf_keras")
    if path.startswith("tools" + os.sep):
        allowed.add("chip_smoke")
    for name, line in _imports(os.path.join(REPO, path)):
        top = name.split(".")[0]
        assert top in allowed or top in sys.stdlib_module_names, (path, line,
                                                                  name)


def test_package_imports_without_triton_or_nvcc():
    mods = [m.name for m in pkgutil.walk_packages(
        strajnet_tpu_torch.__path__, "strajnet_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    for expect in ("ops.warp_gather", "ops.swin_block", "train.optim",
                   "train.state", "train.step", "objective.loss",
                   "objective.schedule", "data.pipeline", "infer.submission",
                   "ops.window_attention", "ops.decoder_tail",
                   "objective.pr_auc", "infer.evaluate", "train.loop",
                   "train.checkpoints", "parallel.ddp", "parallel.mesh",
                   "core.grid",
                   "core.libm", "data.raster", "data.preprocess",
                   "data.womd", "data.vectorize", "data.map_raster",
                   "core.sampling", "tools.timing", "tools.bench",
                   "tools.probe_forward_modes", "tools.profile_parts",
                   "tools.graft_entry", "tools.import_ref_weights",
                   "interop.ref_import", "interop.refload"):
        assert f"strajnet_tpu_torch.{expect}" in mods
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        from strajnet_tpu_torch import _build
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build("warp_gather")


@pytest.mark.parametrize("name", ["TaskConfig", "ModelConfig", "LossConfig",
                                  "TrainConfig"])
def test_config_copy_has_the_fields_and_defaults_of_the_jax_package(name):
    # the port's own fields (SwinV2's block kind) come after the JAX
    # package's, which stay as they are
    ours, ref = getattr(tconfig, name), getattr(jconfig, name)
    extra = tconfig.PORT_ONLY_MODEL_FIELDS if name == "ModelConfig" else ()
    fields = [(f.name, f.default) for f in dataclasses.fields(ours)]
    assert fields[:len(fields) - len(extra)] == [
        (f.name, f.default) for f in dataclasses.fields(ref)]
    assert [k for k, _ in fields[len(fields) - len(extra):]] == list(extra)


@pytest.mark.parametrize("name", ["STRAJNET_CONFIG", "TINY_MODEL_CONFIG",
                                  "ULTRA_TINY_MODEL_CONFIG",
                                  "STRAJNET_TRAIN_PY_CONFIG",
                                  "WAYMO_TASK_CONFIG",
                                  "WAYMO_OGM_TASK_CONFIG"])
def test_config_copy_has_the_presets_of_the_jax_package(name):
    ours, ref = getattr(tconfig, name), getattr(jconfig, name)
    got = dataclasses.asdict(ours)
    defaults = {f.name: f.default
                for f in dataclasses.fields(tconfig.ModelConfig)}
    for k in tconfig.PORT_ONLY_MODEL_FIELDS:
        if k in got:   # at its default: the JAX package's blocks
            assert got.pop(k) == defaults[k]
    assert got == dataclasses.asdict(ref)
    if hasattr(ours, "output_size"):
        assert ours.output_size == ref.output_size
        assert ours.bottleneck_size == ref.bottleneck_size


def test_synthetic_batch_copy_matches_the_jax_package():
    from strajnet_tpu.data.synthetic import synthetic_batch as ref
    from strajnet_tpu_torch.data.synthetic import synthetic_batch as ours
    a = ours(tconfig.TINY_MODEL_CONFIG, 2, seed=5)
    b = ref(jconfig.TINY_MODEL_CONFIG, 2, seed=5)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_submission_copy_matches_the_jax_package():
    from strajnet_tpu.infer import submission as ref
    from strajnet_tpu_torch.infer import submission as ours
    from strajnet_tpu_torch.objective.loss import WaypointGrids
    rng = np.random.default_rng(0)
    grids = WaypointGrids(*(rng.random((1, 2, 8, 8, c)).astype(np.float32)
                            for c in (1, 1, 2, 1)))
    a = ours.quantize_waypoints(grids)
    b = ref.quantize_waypoints(grids)
    assert [dataclasses.astuple(x) for x in a] == [dataclasses.astuple(x)
                                                   for x in b]
    assert ours.SCENARIO_ID == ref.SCENARIO_ID


def test_schema_copy_loads_tensorflow_lazily_and_matches():
    import sys
    from strajnet_tpu.data import schema as ref
    from strajnet_tpu_torch.data import schema as ours
    assert ours.SHAPES == ref.SHAPES
    assert ours.TRAIN_KEYS == ref.TRAIN_KEYS and ours.TEST_KEYS == ref.TEST_KEYS
    with open(ours.__file__) as f:
        tree = ast.parse(f.read())
    top_level = [n for n in tree.body
                 if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert all("tensorflow" not in ast.dump(n) for n in top_level)
    assert "strajnet_tpu_torch.data.pipeline" in sys.modules or \
        importlib.import_module("strajnet_tpu_torch.data.pipeline")


def test_pipeline_copy_reads_a_shard_like_the_jax_package(tmp_path):
    """Two test records at the stored shapes, written with the port's
    ``encode_example`` and read back through the port's pipeline and through
    the JAX package's: the same batches, compact feed included."""
    import tensorflow as tf
    from strajnet_tpu.data import pipeline as ref
    from strajnet_tpu_torch.data import pipeline as ours
    from strajnet_tpu_torch.data.schema import SHAPES, encode_example
    rng = np.random.default_rng(0)
    path = str(tmp_path / "00000new.tfrecords")
    with tf.io.TFRecordWriter(path) as writer:
        for i in range(2):
            feats = {
                "centerlines": rng.standard_normal(SHAPES["centerlines"]),
                "actors": rng.standard_normal(SHAPES["actors"]),
                "occl_actors": rng.standard_normal(SHAPES["occl_actors"]),
                "ogm": rng.random(SHAPES["ogm"]) < 0.1,
                "map_image": rng.integers(-128, 128, SHAPES["map_image"]),
                "vec_flow": rng.standard_normal(SHAPES["vec_flow"]),
            }
            writer.write(encode_example(feats, scenario_id=f"sc-{i}",
                                        test=True))
    for compact in (False, True):
        a = list(ours.as_numpy(ours.make_test_dataset(path, 2, compact)))
        b = list(ref.as_numpy(ref.make_test_dataset(path, 2, compact)))
        assert len(a) == len(b) == 1 and set(a[0]) == set(b[0])
        for k in a[0]:
            assert a[0][k].dtype == b[0][k].dtype, k
            np.testing.assert_array_equal(a[0][k], b[0][k])
        assert a[0]["ogm"].dtype == (np.uint8 if compact else np.float32)
        assert [s.decode() for s in a[0]["scenario/id"]] == ["sc-0", "sc-1"]


def test_train_and_eval_datasets_read_like_the_jax_package(tmp_path):
    """Three train records at the stored shapes through ``make_eval_dataset``
    (whole split and with the remainder dropped, sharded, compact) and
    through ``make_train_dataset`` with a seeded shuffle: the batches of the
    JAX package's pipeline."""
    import tensorflow as tf
    from strajnet_tpu.data import pipeline as ref
    from strajnet_tpu_torch.data import pipeline as ours
    from strajnet_tpu_torch.data.schema import SHAPES, encode_example
    rng = np.random.default_rng(1)
    with tf.io.TFRecordWriter(str(tmp_path / "00000.tfrecords")) as writer:
        for _ in range(3):
            writer.write(encode_example(
                {k: (rng.random(shape) < 0.1).astype(np.float32)
                 for k, shape in SHAPES.items()}))
    pattern = str(tmp_path / "*.tfrecords")

    def same(a, b, sizes):
        a, b = list(ours.as_numpy(a)), list(ref.as_numpy(b))
        assert [x["ogm"].shape[0] for x in a] == sizes == \
            [x["ogm"].shape[0] for x in b]
        for x, y in zip(a, b):
            assert set(x) == set(y)
            for k in x:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k])

    kw = dict(compact=True, drop_remainder=False)
    same(ours.make_eval_dataset(pattern, 2, **kw),
         ref.make_eval_dataset(pattern, 2, **kw), [2, 1])
    same(ours.make_eval_dataset(pattern, 2), ref.make_eval_dataset(pattern, 2),
         [2])
    kw = dict(shard_index=1, shard_count=2, drop_remainder=False)
    same(ours.make_eval_dataset(pattern, 2, **kw),
         ref.make_eval_dataset(pattern, 2, **kw), [1])
    kw = dict(shuffle_buffer=4, seed=7)
    same(ours.make_train_dataset(pattern, 3, **kw),
         ref.make_train_dataset(pattern, 3, **kw), [3])


def test_entry_points_default_to_the_card_and_raise_without_one():
    from strajnet_tpu_torch.device import resolve_device
    from strajnet_tpu_torch.infer import runner
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device()
    with pytest.raises(RuntimeError, match="--device cpu"):
        runner.main(["--no_id_check", "--file_dir", "/nonexistent"])
    from strajnet_tpu_torch.infer import evaluate
    with pytest.raises(RuntimeError, match="--device cpu"):
        evaluate.main(["--file_dir", "/nonexistent"])
    from strajnet_tpu_torch.data import preprocess
    with pytest.raises(RuntimeError, match="--device cpu"):
        preprocess.main(["--file_dir", "/nonexistent"])


def _modules_loaded_by_import(module, names):
    """Which of ``names`` a fresh interpreter holds after importing
    ``module``."""
    import json
    import subprocess
    import sys
    code = (f"import json, sys\nimport {module}\n"
            f"print(json.dumps(sorted(k for k in {tuple(names)!r} "
            "if k in sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", ["strajnet_tpu_torch.train.loop",
                                    "strajnet_tpu_torch.train.checkpoints"])
def test_loop_and_checkpoints_load_no_jax_orbax_or_tensorflow(module):
    """In a fresh interpreter: the training loop and the checkpoints import
    neither JAX, Flax, Orbax nor TensorFlow (the loop loads TensorFlow only
    when it reads TFRecords)."""
    assert _modules_loaded_by_import(
        module, ("jax", "flax", "orbax", "tensorflow")) == []


@pytest.mark.parametrize("module", ["strajnet_tpu_torch.data.raster",
                                    "strajnet_tpu_torch.data.preprocess"])
def test_rasterizer_and_preprocessor_load_no_jax_tensorflow_or_matplotlib(
        module):
    """In a fresh interpreter: the rasterizer and the preprocessor import
    neither JAX, TensorFlow nor matplotlib (the preprocessor loads the two
    where it reads and writes shards and draws the map)."""
    assert _modules_loaded_by_import(
        module, ("jax", "tensorflow", "matplotlib")) == []


@pytest.mark.parametrize("name", ["womd", "vectorize", "map_raster"])
def test_preprocessor_copies_equal_their_originals(name):
    """The numpy modules of the preprocessor are copies: their source is
    the JAX package's with the package renamed."""
    def source(package):
        with open(os.path.join(REPO, package, "data", name + ".py")) as f:
            return f.read()
    assert source("strajnet_tpu_torch") == source("strajnet_tpu").replace(
        "strajnet_tpu.", "strajnet_tpu_torch.")


def test_no_source_of_the_port_states_a_tpu_or_a100_number():
    """The JAX bench's v5e peak, its FLOP count taken from a TPU compile and
    its A100-derived yardstick do not cross over."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        bad += [(os.path.relpath(path, REPO), n) for n in FOREIGN_NUMBERS
                if n in text]
    assert bad == []


def test_keras_import_tables_equal_the_jax_package():
    """The port's copies of the mapping tables and of the name mapping."""
    from strajnet_tpu.interop import ref_import as ref
    from strajnet_tpu_torch.interop import ref_import as ours
    assert ours._DUP_MAP == ref._DUP_MAP
    assert ours._SKIP == ref._SKIP
    assert ours._EXPLICIT_HEAD.pattern == ref._EXPLICIT_HEAD.pattern
    assert ours.trajnet_order() == ref.trajnet_order()
    assert ours.trajnet_order(3) == ref.trajnet_order(3)
    probe = np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 1, 1, 2, 3)
    for a, b in ((ours.fgmsa_order(), ref.fgmsa_order()),
                 (ours.decoder_order(), ref.decoder_order())):
        assert [p for p, _ in a] == [p for p, _ in b]
        for (_, fa), (_, fb) in zip(a, b):
            assert (fa is None) == (fb is None)
            if fa is not None:
                np.testing.assert_array_equal(fa(probe), fb(probe))
    names = ["swin_transformer_encoder/patch_embed/proj/kernel:0",
             "a/patch_embed/proj/kernel:0", "patch_embed/norm/gamma:0",
             "b/all_norm/gamma:0", "c/d/all_norm/beta:0", "all_norm/gamma:0",
             "basic_layer_2/flow_layers0/blocks1/attn/qkv/kernel:0",
             "basic_layer/layers2/downsample/norm/beta:0"]
    seen_a, seen_b = {}, {}
    assert ([ours.keras_name_to_flax_path(n, seen_a) for n in names]
            == [ref.keras_name_to_flax_path(n, seen_b) for n in names])


def test_reference_loader_copy_equals_its_original():
    """``interop/refload.py`` is the JAX package's with no default for the
    reference's source directory: every caller names it."""
    def source(package):
        with open(os.path.join(REPO, package, "interop", "refload.py")) as f:
            return f.read()
    theirs = re.sub(r"\nDEFAULT_REF_DIR = .*\n", "\n", source("strajnet_tpu"))
    assert source("strajnet_tpu_torch") == theirs.replace(
        "fg=True,\n", "fg=True, *,\n").replace(": str = DEFAULT_REF_DIR",
                                                ": str")


@pytest.mark.parametrize("module", ["strajnet_tpu_torch.tools.bench",
                                    "strajnet_tpu_torch.tools.profile_parts",
                                    "strajnet_tpu_torch.interop.ref_import",
                                    "strajnet_tpu_torch.tools."
                                    "import_ref_weights"])
def test_tools_and_keras_import_load_no_jax_or_tensorflow(module):
    """In a fresh interpreter: the tools and the Keras import load neither
    JAX nor TensorFlow (the import loads TensorFlow when it builds the
    reference model)."""
    assert _modules_loaded_by_import(
        module, ("jax", "flax", "tensorflow", "tf_keras")) == []


@pytest.mark.parametrize("module", ["strajnet_tpu_torch.parallel.mesh",
                                    "strajnet_tpu_torch.tools.graft_entry"])
def test_mesh_and_dry_run_load_no_jax(module):
    """In a fresh interpreter: tensor parallelism and the multi-rank dry run
    load neither JAX, Flax, Optax nor the JAX package."""
    assert _modules_loaded_by_import(
        module, ("jax", "flax", "optax", "strajnet_tpu")) == []


def test_tools_default_to_the_card_and_raise_without_one():
    from strajnet_tpu_torch.tools import (bench, graft_entry,
                                          probe_forward_modes, profile_parts)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    for main in (bench.main, probe_forward_modes.main, profile_parts.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="--device cpu"):
        graft_entry.dryrun_multichip(4)
