"""Preprocessed-TFRecord schema + parsers (parity: reference train.py:71-103,
inference.py:67-96).

The offline preprocessor writes the same
records the reference's ``Processor`` emits (data_preprocessing.py:417-437):
raw little-endian bytes per feature, shapes below. Parsers run in tf.data on
the host; the 512->256 center crop of GT rasters is kept in the parser
exactly as the reference does (train.py:93-99).
"""

from __future__ import annotations

from typing import Dict

import numpy as np



def _tf():
    """TensorFlow, loaded at first use: only reading or writing real shards
    needs it. It is kept off the GPUs, which belong to PyTorch."""
    import tensorflow as tf
    tf.config.set_visible_devices([], "GPU")
    return tf


# raw stored shapes (before crop)
SHAPES = {
    "centerlines": (256, 10, 7),      # float64
    "actors": (48, 11, 8),            # float64
    "occl_actors": (16, 11, 8),       # float64
    "ogm": (512, 512, 11, 2),         # bool
    "map_image": (256, 256, 3),       # int8
    "gt_obs_ogm": (8, 512, 512, 1),   # bool
    "gt_occ_ogm": (8, 512, 512, 1),   # bool
    "gt_flow": (8, 512, 512, 2),      # float32
    "origin_flow": (8, 512, 512, 1),  # float32
    "vec_flow": (512, 512, 2),        # float32
    "byc_flow": (512, 512, 2),        # float32 (written, never read — §2.8-12)
}

CROP = slice(128, 128 + 256)


def _feature_spec(keys):
    tf = _tf()
    return {k: tf.io.FixedLenFeature([], tf.string) for k in keys}


TRAIN_KEYS = ("centerlines", "actors", "occl_actors", "ogm", "map_image",
              "gt_obs_ogm", "gt_occ_ogm", "gt_flow", "origin_flow",
              "vec_flow")
TEST_KEYS = ("centerlines", "actors", "occl_actors", "ogm", "map_image",
             "scenario/id", "vec_flow")


def parse_train_example(example_proto, compact: bool = False):
    """Parses one train/val record (reference train.py:85-103).

    ``compact=True`` keeps binary grids as uint8 and the map raster as
    float16 instead of widening everything to float32 on the host — a
    bit-exact 2.3x cut of host->device feed bytes (the grids are {0,1} and
    the map values k/256, k in [-128,127], are exact in f16; flows stay
    f32). The train/eval/predict steps cast back to f32 on device
    (train/step.py::ensure_f32), so downstream numerics are identical.
    """
    tf = _tf()
    d = tf.io.parse_single_example(example_proto,
                                   _feature_spec(TRAIN_KEYS))
    grid_t = tf.uint8 if compact else tf.float32
    map_t = tf.float16 if compact else tf.float32
    out = {}
    out["centerlines"] = tf.cast(
        tf.reshape(tf.io.decode_raw(d["centerlines"], tf.float64),
                   SHAPES["centerlines"]), tf.float32)
    out["actors"] = tf.cast(
        tf.reshape(tf.io.decode_raw(d["actors"], tf.float64),
                   SHAPES["actors"]), tf.float32)
    out["occl_actors"] = tf.cast(
        tf.reshape(tf.io.decode_raw(d["occl_actors"], tf.float64),
                   SHAPES["occl_actors"]), tf.float32)

    out["gt_flow"] = tf.reshape(
        tf.io.decode_raw(d["gt_flow"], tf.float32),
        SHAPES["gt_flow"])[:, CROP, CROP, :]
    out["origin_flow"] = tf.reshape(
        tf.io.decode_raw(d["origin_flow"], tf.float32),
        SHAPES["origin_flow"])[:, CROP, CROP, :]

    out["ogm"] = tf.reshape(
        tf.cast(tf.io.decode_raw(d["ogm"], tf.bool), grid_t),
        SHAPES["ogm"])
    out["gt_obs_ogm"] = tf.reshape(
        tf.cast(tf.io.decode_raw(d["gt_obs_ogm"], tf.bool), grid_t),
        SHAPES["gt_obs_ogm"])[:, CROP, CROP, :]
    out["gt_occ_ogm"] = tf.reshape(
        tf.cast(tf.io.decode_raw(d["gt_occ_ogm"], tf.bool), grid_t),
        SHAPES["gt_occ_ogm"])[:, CROP, CROP, :]

    out["map_image"] = tf.cast(
        tf.cast(tf.reshape(tf.io.decode_raw(d["map_image"], tf.int8),
                           SHAPES["map_image"]), tf.float32) / 256.0, map_t)
    out["vec_flow"] = tf.reshape(
        tf.io.decode_raw(d["vec_flow"], tf.float32), SHAPES["vec_flow"])
    return out


def parse_test_example(example_proto, compact: bool = False):
    """Parses one test record incl. scenario id (inference.py:84-96).

    ``compact`` as in :func:`parse_train_example` (bit-exact byte shrink).
    """
    tf = _tf()
    d = tf.io.parse_single_example(example_proto, _feature_spec(TEST_KEYS))
    grid_t = tf.uint8 if compact else tf.float32
    map_t = tf.float16 if compact else tf.float32
    out = {}
    out["centerlines"] = tf.cast(
        tf.reshape(tf.io.decode_raw(d["centerlines"], tf.float64),
                   SHAPES["centerlines"]), tf.float32)
    out["actors"] = tf.cast(
        tf.reshape(tf.io.decode_raw(d["actors"], tf.float64),
                   SHAPES["actors"]), tf.float32)
    out["occl_actors"] = tf.cast(
        tf.reshape(tf.io.decode_raw(d["occl_actors"], tf.float64),
                   SHAPES["occl_actors"]), tf.float32)
    out["ogm"] = tf.reshape(
        tf.cast(tf.io.decode_raw(d["ogm"], tf.bool), grid_t),
        SHAPES["ogm"])
    out["map_image"] = tf.cast(
        tf.cast(tf.reshape(tf.io.decode_raw(d["map_image"], tf.int8),
                           SHAPES["map_image"]), tf.float32) / 256.0, map_t)
    out["vec_flow"] = tf.reshape(
        tf.io.decode_raw(d["vec_flow"], tf.float32), SHAPES["vec_flow"])
    out["scenario/id"] = d["scenario/id"]
    return out


def encode_example(features: Dict[str, np.ndarray],
                   scenario_id: str = None, test: bool = False) -> bytes:
    """Serializes one record with the reference's raw-bytes convention
    (data_preprocessing.py:417-437)."""
    tf = _tf()

    def b(x):
        return tf.train.Feature(
            bytes_list=tf.train.BytesList(value=[x.tobytes()]))

    feat = {
        "centerlines": b(features["centerlines"].astype(np.float64)),
        "actors": b(features["actors"].astype(np.float64)),
        "occl_actors": b(features["occl_actors"].astype(np.float64)),
        "ogm": b(features["ogm"].astype(bool)),
        "map_image": b(features["map_image"].astype(np.int8)),
        "vec_flow": b(features["vec_flow"].astype(np.float32)),
    }
    if "byc_flow" in features:
        feat["byc_flow"] = b(features["byc_flow"].astype(np.float32))
    if not test:
        feat.update({
            "gt_obs_ogm": b(features["gt_obs_ogm"].astype(bool)),
            "gt_occ_ogm": b(features["gt_occ_ogm"].astype(bool)),
            "gt_flow": b(features["gt_flow"].astype(np.float32)),
            "origin_flow": b(features["origin_flow"].astype(np.float32)),
        })
    if scenario_id is not None:
        feat["scenario/id"] = tf.train.Feature(
            bytes_list=tf.train.BytesList(
                value=[scenario_id.encode("utf-8")]))
    ex = tf.train.Example(features=tf.train.Features(feature=feat))
    return ex.SerializeToString()
