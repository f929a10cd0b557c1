"""Waymo Open Motion Dataset ``tf_example`` schema + raster palettes.

Self-contained re-declaration (the ``waymo_open_dataset`` package is not
installed). Feature spec mirrors the public WOMD tf_example format used by
the reference (reference data_utils.py:5-135): 20000 roadgraph samples, 128
agents x (10 past + 1 current + 80 future) steps, 16 traffic lights.
"""

from __future__ import annotations

from typing import Dict

NUM_ROADGRAPH_SAMPLES = 20000
NUM_AGENTS = 128
NUM_PAST_STEPS = 10
NUM_FUTURE_STEPS = 80
NUM_TRAFFIC_LIGHTS = 16

# Agent types (scenario.proto Track.ObjectType).
TYPE_UNSET = 0
TYPE_VEHICLE = 1
TYPE_PEDESTRIAN = 2
TYPE_CYCLIST = 3
TYPE_OTHER = 4
ALL_AGENT_TYPES = (TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_CYCLIST)


def features_description():
    """tf.io feature spec for one WOMD tf_example scenario."""
    import tensorflow as tf

    fl = tf.io.FixedLenFeature
    spec: Dict[str, object] = {
        "roadgraph_samples/dir": fl([NUM_ROADGRAPH_SAMPLES, 3], tf.float32),
        "roadgraph_samples/id": fl([NUM_ROADGRAPH_SAMPLES, 1], tf.int64),
        "roadgraph_samples/type": fl([NUM_ROADGRAPH_SAMPLES, 1], tf.int64),
        "roadgraph_samples/valid": fl([NUM_ROADGRAPH_SAMPLES, 1], tf.int64),
        "roadgraph_samples/xyz": fl([NUM_ROADGRAPH_SAMPLES, 3], tf.float32),
        "state/id": fl([NUM_AGENTS], tf.float32),
        "state/type": fl([NUM_AGENTS], tf.float32),
        "state/is_sdc": fl([NUM_AGENTS], tf.int64),
        "state/tracks_to_predict": fl([NUM_AGENTS], tf.int64),
        "scenario/id": fl([1], tf.string),
    }
    float_fields = ("bbox_yaw", "height", "length", "width", "vel_yaw",
                    "velocity_x", "velocity_y", "x", "y", "z", "speed")
    int_fields = ("timestamp_micros", "valid")
    for time, steps in (("past", NUM_PAST_STEPS), ("current", 1),
                        ("future", NUM_FUTURE_STEPS)):
        for f in float_fields:
            if time == "future" and f == "speed":
                continue  # future speed not in the reference spec
            spec[f"state/{time}/{f}"] = fl([NUM_AGENTS, steps], tf.float32)
        for f in int_fields:
            spec[f"state/{time}/{f}"] = fl([NUM_AGENTS, steps], tf.int64)
    for time, steps in (("current", 1), ("past", NUM_PAST_STEPS)):
        spec[f"traffic_light_state/{time}/state"] = fl(
            [steps, NUM_TRAFFIC_LIGHTS], tf.int64)
        spec[f"traffic_light_state/{time}/valid"] = fl(
            [steps, NUM_TRAFFIC_LIGHTS], tf.int64)
        for f in ("x", "y", "z"):
            spec[f"traffic_light_state/{time}/{f}"] = fl(
                [steps, NUM_TRAFFIC_LIGHTS], tf.float32)
    return spec


def parse_womd_example(example_proto):
    """parse_tf_example equivalent (waymo occupancy_flow_data)."""
    import tensorflow as tf

    return tf.io.parse_single_example(example_proto, features_description())


# Raster palettes (reference data_utils.py:137-150): matplotlib color /
# linestyle / linewidth per roadgraph type, and traffic-light state colors.
ROAD_LABEL = {
    1: "LaneCenter-Freeway", 2: "LaneCenter-SurfaceStreet",
    3: "LaneCenter-BikeLane", 6: "RoadLine-BrokenSingleWhite",
    7: "RoadLine-SolidSingleWhite", 8: "RoadLine-SolidDoubleWhite",
    9: "RoadLine-BrokenSingleYellow", 10: "RoadLine-BrokenDoubleYellow",
    11: "Roadline-SolidSingleYellow", 12: "Roadline-SolidDoubleYellow",
    13: "RoadLine-PassingDoubleYellow", 15: "RoadEdgeBoundary",
    16: "RoadEdgeMedian", 17: "StopSign", 18: "Crosswalk", 19: "SpeedBump",
}

ROAD_LINE_MAP = {
    1: ["xkcd:grey", "solid", 14], 2: ["xkcd:grey", "solid", 14],
    3: ["xkcd:grey", "solid", 10], 6: ["w", "dashed", 2],
    7: ["w", "solid", 2], 8: ["w", "solid", 2],
    9: ["xkcd:yellow", "dashed", 4], 10: ["xkcd:yellow", "dashed", 2],
    11: ["xkcd:yellow", "solid", 2], 12: ["xkcd:yellow", "solid", 3],
    13: ["xkcd:yellow", "dotted", 1.5], 15: ["y", "solid", 4.5],
    16: ["y", "solid", 4.5], 17: ["r", ".", 40], 18: ["b", "solid", 13],
    19: ["xkcd:orange", "solid", 13],
}

LIGHT_LABEL = {0: "Unknown", 1: "Arrow_Stop", 2: "Arrow_Caution",
               3: "Arrow_Go", 4: "Stop", 5: "Caution", 6: "Go",
               7: "Flashing_Stop", 8: "Flashing_Caution"}
LIGHT_STATE_MAP = {0: "k", 1: "r", 2: "y", 3: "g", 4: "r", 5: "y", 6: "g",
                   7: "r", 8: "y"}
