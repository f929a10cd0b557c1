"""The port stands alone: it imports nothing of JAX or of the JAX package.

Walks every source file of ``strajnet_tpu_torch`` and ``chip_smoke.py`` with
``ast``; checks that the package imports where neither ``triton`` nor ``nvcc``
exists; that the port's own copies of the framework-free modules still agree
with the JAX package's; and that the entry points run on the card unless told
otherwise.
"""

import ast
import dataclasses
import importlib
import os
import pkgutil
import shutil

import numpy as np
import pytest
import torch

import strajnet_tpu.config as jconfig
import strajnet_tpu_torch
import strajnet_tpu_torch.config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "chex", "strajnet_tpu")


def _port_sources():
    root = os.path.join(REPO, "strajnet_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
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
    itself and (lazily, to read real shards) tensorflow."""
    import sys
    allowed = {"torch", "numpy", "strajnet_tpu_torch", "tensorflow"}
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
                   "objective.schedule", "data.pipeline", "infer.submission"):
        assert f"strajnet_tpu_torch.{expect}" in mods
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        from strajnet_tpu_torch import _build
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build("warp_gather")


@pytest.mark.parametrize("name", ["TaskConfig", "ModelConfig", "LossConfig",
                                  "TrainConfig"])
def test_config_copy_has_the_fields_and_defaults_of_the_jax_package(name):
    ours, ref = getattr(tconfig, name), getattr(jconfig, name)
    assert ([(f.name, f.default) for f in dataclasses.fields(ours)]
            == [(f.name, f.default) for f in dataclasses.fields(ref)])


@pytest.mark.parametrize("name", ["STRAJNET_CONFIG", "TINY_MODEL_CONFIG",
                                  "ULTRA_TINY_MODEL_CONFIG",
                                  "STRAJNET_TRAIN_PY_CONFIG",
                                  "WAYMO_TASK_CONFIG",
                                  "WAYMO_OGM_TASK_CONFIG"])
def test_config_copy_has_the_presets_of_the_jax_package(name):
    ours, ref = getattr(tconfig, name), getattr(jconfig, name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
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
