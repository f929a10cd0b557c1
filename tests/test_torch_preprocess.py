"""The port's offline preprocessor against the JAX package's, on the CPU.

Tolerance 0 throughout: every grid, feature and record of the port equals
the JAX package's bit for bit.

The JAX functions run under ``jax.jit``, as the JAX ``Processor`` runs its
rasterizer. Jitted, XLA's CPU backend fuses the first product of
``x * cos - y * sin`` and of the box-point sums into one multiply-add, and
it takes sine and cosine from the C library; the port computes the same
(``core/libm.py``). The tests below show both effects.

Scenarios are ``tests/test_preprocess.py::fake_scenario`` made harder:
mixed vehicles, pedestrians, cyclists and others, random yaws, sizes and
offsets, agents seen only in the future, agents that drop out mid-history
or leave in the future, lanes and lines of every road type, and traffic
lights. The rasterizer runs at the small ``CFG`` of that file (64^2, 12x4
points a box) and, with ``Processor`` and the CLI, at the full WOMD
geometry (512^2 OGM, 48x16 points a box, 128 agents).
"""

import dataclasses
import functools
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strajnet_tpu.config import \
    WAYMO_OGM_TASK_CONFIG as JWAYMO_OGM_TASK_CONFIG
from strajnet_tpu.core import grid as jgrid
from strajnet_tpu.data import preprocess as jpreprocess
from strajnet_tpu.data import raster as jraster
from strajnet_tpu.data.schema import encode_example as jencode_example
from strajnet_tpu_torch.config import WAYMO_OGM_TASK_CONFIG, TaskConfig
from strajnet_tpu_torch.core import grid, libm
from strajnet_tpu_torch.data import preprocess, raster, womd
from strajnet_tpu_torch.data.schema import encode_example
from strajnet_tpu_torch.data.womd import (NUM_AGENTS, NUM_FUTURE_STEPS,
                                          NUM_PAST_STEPS, ROAD_LINE_MAP)
from test_preprocess import CFG as JCFG
from test_preprocess import fake_scenario

torch.set_num_threads(2)
CFG = TaskConfig(**dataclasses.asdict(JCFG))
CPU = "cpu"
STEPS = (("past", NUM_PAST_STEPS), ("current", 1),
         ("future", NUM_FUTURE_STEPS))
ALL = ["past", "current", "future"]


def scenario(seed: int, n_agents: int = 40, n_lines: int = 12):
    """A WOMD scenario dict (numpy, the parsed shapes and dtypes)."""
    s = fake_scenario(n_agents=n_agents, seed=seed)
    rng = np.random.RandomState(1000 + seed)
    n = n_agents + 1  # the SDC and the agents
    off_x, off_y = rng.uniform(-25, 25, (2, NUM_AGENTS, 1))
    yaw = rng.uniform(-np.pi, np.pi, (NUM_AGENTS, 1))
    length = rng.uniform(0.5, 6.0, (NUM_AGENTS, 1))
    width = rng.uniform(0.5, 2.5, (NUM_AGENTS, 1))
    for time, steps in STEPS:
        def field(name, value):
            s[f"state/{time}/{name}"] = np.broadcast_to(
                value, (NUM_AGENTS, steps)).astype(np.float32)
        field("x", s[f"state/{time}/x"] + off_x
              + rng.normal(0, 0.3, (NUM_AGENTS, steps)))
        field("y", s[f"state/{time}/y"] + off_y
              + rng.normal(0, 0.3, (NUM_AGENTS, steps)))
        field("bbox_yaw", yaw + rng.normal(0, 0.1, (NUM_AGENTS, steps)))
        field("length", length)
        field("width", width)
    types = np.zeros(NUM_AGENTS, np.float32)
    types[:n] = rng.choice([1, 2, 3, 4], n, p=[0.55, 0.2, 0.2, 0.05])
    types[0] = 1
    s["state/type"] = types
    past, cur = s["state/past/valid"], s["state/current/valid"]
    fut = s["state/future/valid"]
    picks = rng.permutation(np.arange(1, n))
    k = max(n // 6, 1)
    past[picks[:k]] = 0        # seen only in the future: occluded
    cur[picks[:k]] = 0
    past[picks[k:2 * k], 4:] = 0   # dropped out mid-history
    cur[picks[k:2 * k]] = 0
    fut[picks[2 * k:3 * k], 30:] = 0   # leave in the future

    # roadgraph: polylines of every drawn road type and some others
    rg = s["roadgraph_samples/xyz"]
    i = 0
    kinds = sorted(ROAD_LINE_MAP) + [4, 5, 20]
    for line in range(n_lines):
        count = rng.randint(5, 40)
        start, heading = rng.uniform(-50, 50, 2), rng.uniform(-np.pi, np.pi)
        step = np.array([np.cos(heading), np.sin(heading)]) * 1.5
        rg[i:i + count, :2] = start + np.arange(count)[:, None] * step
        s["roadgraph_samples/dir"][i:i + count, :2] = step / 1.5
        s["roadgraph_samples/id"][i:i + count, 0] = 100 + line
        s["roadgraph_samples/type"][i:i + count, 0] = kinds[line % len(kinds)]
        s["roadgraph_samples/valid"][i:i + count, 0] = 1
        i += count
    s["traffic_light_state/current/valid"][0, :4] = 1
    s["traffic_light_state/current/state"][0, :4] = rng.randint(0, 9, 4)
    s["traffic_light_state/current/x"][0, :4] = rng.uniform(0, 256, 4)
    s["traffic_light_state/current/y"][0, :4] = rng.uniform(0, 256, 4)
    return s


def assert_identical(port, ref, what=""):
    """Tolerance 0: the same dtype, shape and bytes."""
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape, (
        what, port.dtype, ref.dtype, port.shape, ref.shape)
    if port.tobytes() != ref.tobytes():
        differ = int((port.view(np.uint8) != ref.view(np.uint8)).sum())
        pytest.fail(f"{what}: {differ} bytes differ")


def jitted(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def jax_sample(n=200_000, seed=0):
    """float32 angles over every path of the C library's sinf/cosf."""
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(-1, 1, n), rng.uniform(-8, 8, n),
             rng.uniform(-130, 130, n // 4),
             10.0 ** rng.uniform(-40, 38, n // 4) * rng.choice([-1, 1],
                                                               n // 4),
             [0.0, -0.0, 119.99, 120.0, -120.0, np.pi / 4, 0.75, 2.0 ** -12,
              2.0 ** -13, 1e-45, np.inf, -np.inf, np.nan]]
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("name", ["sin", "cos"])
def test_sinf_and_cosf_equal_xla_cpu_and_torch_does_not(name):
    x = jax_sample()
    ref = np.asarray(jax.jit(getattr(jnp, name))(x))
    ours = getattr(libm, name + "f")(torch.from_numpy(x))
    assert_identical(ours, ref, name)
    finite = np.isfinite(x)
    plain = getattr(torch, name)(torch.from_numpy(x)).numpy()
    assert (plain[finite] != ref[finite]).mean() > 0.01


def test_fmaf_is_the_multiply_add_xla_fuses():
    rng = np.random.default_rng(1)
    a, b, c = rng.standard_normal((3, 100_000)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    assert_identical(libm.fmaf(ta, tb, tc), ref)
    assert (ta * tb + tc).numpy().tobytes() != ref.tobytes()


@pytest.mark.parametrize("larger_box", [False, True])
def test_transform_to_image_coordinates_equals_jax(larger_box):
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-40, 40, (2, 10_000)).astype(np.float32)
    ours = grid.transform_to_image_coordinates(x, y, CFG, larger_box)
    ref = jgrid.transform_to_image_coordinates(x, y, JCFG, larger_box)
    for name, a, b in zip(("x_img", "y_img", "in_fov"), ours, ref):
        assert_identical(a, b, name)


def test_rotate_points_around_origin_equals_jax():
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-40, 40, (2, 10_000)).astype(np.float32)
    for angle in (0.3, -2.9, np.float32(1.7)):
        ours = grid.rotate_points_around_origin(x, y, angle)
        ref = jgrid.rotate_points_around_origin(x, y, angle)
        for a, b in zip(ours, ref):
            assert_identical(a, b, f"angle {angle}")


def test_stack_history_narrows_as_jax_does():
    s = scenario(0)
    s64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
           for k, v in s.items()}
    for field in ("x", "valid"):
        ours = raster.stack_history(s64, ALL, field, CPU)
        ref = jraster.stack_history(s64, ALL, field)
        assert_identical(ours, ref, field)


@pytest.mark.parametrize("seed", [0, 1])
def test_ego_frame_and_sampled_points_equal_jax(seed):
    s = scenario(seed)
    ours = raster.ego_frame_fields(s, ALL, CFG, CPU)
    ref = jitted(jraster.ego_frame_fields, times=ALL, config=JCFG)(s)
    for name, a, b in zip(("x", "y", "bbox_yaw", "length", "width",
                           "valid"), ours, ref):
        assert_identical(a, b, name)
    ours = raster.sample_agent_points(s, ALL, CFG, CPU)
    ref = jitted(jraster.sample_agent_points, times=ALL, config=JCFG)(s)
    for name, a, b in zip(ours._fields, ours, ref):
        assert_identical(a, b, name)
    cells = raster.to_grid(ours.x, ours.y, CFG)
    ref_cells = jitted(jraster.to_grid, config=JCFG)(ref.x, ref.y)
    for a, b in zip(cells, ref_cells):
        assert_identical(a, b, "to_grid")


@pytest.mark.parametrize("times", [["current"], ["future"], ALL])
@pytest.mark.parametrize("observed,occluded",
                         [(True, True), (True, False), (False, True)])
def test_render_occupancy_equals_jax(times, observed, occluded):
    for seed in (0, 1):
        s = scenario(seed)
        ours = raster.render_occupancy(s, times, CFG, observed, occluded,
                                       device=CPU)
        ref = jitted(jraster.render_occupancy, times=times, config=JCFG,
                     include_observed=observed,
                     include_occluded=occluded)(s)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert_identical(ours[k], ref[k], f"seed {seed} class {k}")
        if observed or "future" in times:  # the occluded have no history
            assert sum(float(g.sum()) for g in ours.values()) > 0


def test_render_occupancy_needs_observed_or_occluded():
    s = scenario(0)
    with pytest.raises(ValueError, match="observed and/or occluded"):
        raster.render_occupancy(s, ["future"], CFG, False, False, CPU)
    with pytest.raises(ValueError, match="observed and/or occluded"):
        jraster.render_occupancy(s, ["future"], JCFG, False, False)


@pytest.mark.parametrize("times", [["past", "current"], ALL],
                         ids=["history", "all"])
def test_render_backward_flow_equals_jax(times):
    for seed in (0, 1):
        s = scenario(seed)
        ours = raster.render_backward_flow(s, times, CFG, waypoint_size=10,
                                           device=CPU)
        ref = jitted(jraster.render_backward_flow, times=times, config=JCFG,
                     waypoint_size=10)(s)
        for k in ref:
            assert_identical(ours[k], ref[k], f"seed {seed} class {k}")
        assert float(ours[1].abs().sum()) > 0


def test_eager_jax_rounds_the_box_points_otherwise():
    """What the jitted reference is for: with every product rounded, as
    JAX computes the expressions eagerly, some box points land elsewhere."""
    s = scenario(0, n_agents=127)
    ours = raster.sample_agent_points(s, ALL, WAYMO_OGM_TASK_CONFIG, CPU)
    ref = jraster.sample_agent_points(s, ALL, JWAYMO_OGM_TASK_CONFIG)
    assert (ours.x.numpy() != np.asarray(ref.x)).mean() > 0.01


@pytest.mark.parametrize("with_future", [False, True])
def test_create_timestep_grids_equals_jax(with_future):
    s = scenario(2)
    ours = raster.create_timestep_grids(s, CFG, with_future, CPU)
    ref = jitted(jraster.create_timestep_grids, config=JCFG,
                 with_future=with_future)(s)
    for name in ref._fields:
        for k, b in getattr(ref, name).items():
            a = getattr(ours, name)[k]
            if b is None:
                assert a is None, name
            else:
                assert_identical(a, b, f"{name} class {k}")


@pytest.mark.parametrize("cumulative", [False, True])
def test_create_waypoint_grids_equals_jax(cumulative):
    s = scenario(3)
    ours_cfg = dataclasses.replace(CFG, cumulative_waypoints=cumulative)
    ref_cfg = dataclasses.replace(JCFG, cumulative_waypoints=cumulative)
    grids = raster.create_timestep_grids(s, ours_cfg, device=CPU)
    ref_grids = jitted(jraster.create_timestep_grids, config=ref_cfg)(s)
    for obj_type in (1, 2):
        ours = raster.create_waypoint_grids(grids, ours_cfg, obj_type)
        ref = jraster.create_waypoint_grids(ref_grids, ref_cfg, obj_type)
        for name, a, b in zip(ours._fields, ours, ref):
            assert_identical(a, b, f"{name} class {obj_type}")


def assert_same_features(ours, ref, with_future):
    assert list(ours) == list(ref)
    for k in ref:
        assert_identical(ours[k], ref[k], k)
    for sc_id in (None, "sc-1"):
        record = encode_example(ours, scenario_id=sc_id,
                                test=not with_future)
        assert record == encode_example(ref, scenario_id=sc_id,
                                        test=not with_future)
        assert record == jencode_example(ref, scenario_id=sc_id,
                                         test=not with_future)


@pytest.mark.parametrize("with_future", [False, True])
def test_process_scenario_equals_jax_at_64(with_future):
    s = scenario(4)
    kw = dict(max_actors=8, max_occu=4, rasterisation_size=64)
    ours = preprocess.Processor(config=CFG, ogm_config=CFG, device=CPU,
                                **kw).process_scenario(s, with_future)
    ref = jpreprocess.Processor(config=JCFG, ogm_config=JCFG,
                                **kw).process_scenario(s, with_future)
    assert_same_features(ours, ref, with_future)
    assert ours["ogm"].any() and np.abs(ours["actors"]).sum() > 0


def test_process_scenario_equals_jax_at_full_geometry():
    s = scenario(5, n_agents=127, n_lines=150)
    ours = preprocess.Processor(device=CPU).process_scenario(s)
    ref = jpreprocess.Processor().process_scenario(s)
    assert_same_features(ours, ref, True)
    assert ours["ogm"].shape == (512, 512, 11, 2)
    assert ours["gt_flow"].shape == (8, 512, 512, 2)
    assert np.abs(ours["gt_flow"]).sum() > 0


def write_womd_shard(path, scenarios):
    """Raw WOMD tf_examples: the fields of ``womd.features_description``,
    zeros where a scenario has none."""
    import tensorflow as tf
    with tf.io.TFRecordWriter(path) as writer:
        for sc_id, s in scenarios:
            feature = {}
            for key, spec in womd.features_description().items():
                if key == "scenario/id":
                    feature[key] = tf.train.Feature(bytes_list=tf.train.
                                                    BytesList(value=[sc_id]))
                    continue
                value = np.asarray(s.get(key, np.zeros(spec.shape)))
                assert value.shape == tuple(spec.shape), key
                if spec.dtype == tf.int64:
                    feature[key] = tf.train.Feature(int64_list=tf.train.
                                                    Int64List(value=value.astype(
                                                        np.int64).ravel()))
                else:
                    feature[key] = tf.train.Feature(float_list=tf.train.
                                                    FloatList(value=value.astype(
                                                        np.float32).ravel()))
            example = tf.train.Example(
                features=tf.train.Features(feature=feature))
            writer.write(example.SerializeToString())


def records(path):
    """The records of a TFRecord file, each re-serialized with its feature
    map in key order: protobuf orders a map by a hash seeded per process,
    so the same features serialize to other bytes in another process (the
    JAX preprocessor's records too)."""
    import tensorflow as tf
    return [tf.train.Example.FromString(r.numpy()).SerializeToString(
        deterministic=True) for r in tf.data.TFRecordDataset(str(path))]


def test_main_writes_the_records_of_the_jax_preprocessor(tmp_path,
                                                         monkeypatch):
    """A validation shard of three WOMD scenarios, two of them in the
    whitelist: the port's CLI on the CPU, its worker started by spawn,
    against the JAX package's ``_process_one``; every feature of every
    record byte for byte."""
    raw, ids = tmp_path / "raw" / "validation", tmp_path / "ids"
    raw.mkdir(parents=True)
    ids.mkdir()
    shard = raw / "validation_tfexample.tfrecord-00003-of-00150"
    write_womd_shard(str(shard), [
        (b"sc-a", scenario(6, n_agents=60, n_lines=40)),
        (b"sc-b", scenario(7, n_agents=127, n_lines=40)),
        (b"sc-c", scenario(8))])
    (ids / "validation_scenario_ids.txt").write_text("sc-c\nsc-a\n")

    # the spawned worker reads its thread count from the environment
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    preprocess.main(["--device", "cpu", "--pool", "1", "--file_dir",
                     str(tmp_path / "raw"), "--save_dir",
                     str(tmp_path / "ours"), "--ids_dir", str(ids),
                     "--splits", "validation"])
    jpreprocess._process_one(str(shard), str(tmp_path / "ref"), str(ids),
                             "validation")
    ours = records(tmp_path / "ours" / "val" / "00003new.tfrecords")
    ref = records(tmp_path / "ref" / "val" / "00003new.tfrecords")
    assert len(ours) == 2 and ours == ref


def test_processor_and_rasterizer_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="--device cpu"):
        preprocess.Processor()
    with pytest.raises(RuntimeError, match="--device cpu"):
        raster.render_occupancy(scenario(0), ["current"], CFG)
