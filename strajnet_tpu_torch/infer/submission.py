"""Waymo challenge submission writer (parity: reference inference.py:160-252).

Per waypoint the reference quantizes and zlib-compresses (inference.py:
166-182): observed/occluded occupancy -> round(p*255) uint8, flow ->
clip(round(f), -128, 127) int8; each byte-blob goes into a ``Waypoint``
message inside ``ScenarioPrediction`` inside ``ChallengeSubmission``,
serialized as one binary proto per test shard named
``occupancy_flow_submission.binproto-XXXXX-of-00150`` (inference.py:244).

The proto schemas are re-declared locally (waymo_open_dataset is not
installed — SURVEY.md §7); field numbers mirror
waymo_open_dataset/protos/occupancy_flow_submission.proto and are kept in
one table below for easy audit.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from strajnet_tpu_torch.infer.proto import (
    encode_bool_field,
    encode_bytes_field,
    encode_message_field,
)

# Field numbers (occupancy_flow_submission.proto).
WAYPOINT_OBSERVED = 1
WAYPOINT_OCCLUDED = 2
WAYPOINT_FLOW = 3

SCENARIO_ID = 1
SCENARIO_WAYPOINTS = 2

SUBMISSION_ACCOUNT_NAME = 1
SUBMISSION_UNIQUE_METHOD_NAME = 2
SUBMISSION_AUTHORS = 3
SUBMISSION_AFFILIATION = 4
SUBMISSION_DESCRIPTION = 5
SUBMISSION_METHOD_LINK = 6
SUBMISSION_SCENARIO_PREDICTIONS = 7
SUBMISSION_USES_LIDAR_DATA = 8
SUBMISSION_USES_CAMERA_DATA = 9
SUBMISSION_USES_PUBLIC_MODEL_PRETRAINING = 10


@dataclasses.dataclass
class Waypoint:
    observed_vehicles_occupancy: bytes = b""
    occluded_vehicles_occupancy: bytes = b""
    all_vehicles_flow: bytes = b""

    def serialize(self) -> bytes:
        out = b""
        out += encode_bytes_field(WAYPOINT_OBSERVED,
                                  self.observed_vehicles_occupancy)
        out += encode_bytes_field(WAYPOINT_OCCLUDED,
                                  self.occluded_vehicles_occupancy)
        out += encode_bytes_field(WAYPOINT_FLOW, self.all_vehicles_flow)
        return out


@dataclasses.dataclass
class ScenarioPrediction:
    scenario_id: str = ""
    waypoints: List[Waypoint] = dataclasses.field(default_factory=list)

    def serialize(self) -> bytes:
        out = encode_bytes_field(SCENARIO_ID, self.scenario_id)
        for wp in self.waypoints:
            out += encode_message_field(SCENARIO_WAYPOINTS, wp.serialize())
        return out


@dataclasses.dataclass
class ChallengeSubmission:
    account_name: str = ""
    unique_method_name: str = ""
    authors: List[str] = dataclasses.field(default_factory=lambda: [""])
    affiliation: str = ""
    description: str = ""
    method_link: str = ""
    uses_lidar_data: bool = False
    uses_camera_data: bool = False
    uses_public_model_pretraining: bool = False
    scenario_predictions: List[ScenarioPrediction] = dataclasses.field(
        default_factory=list)

    def serialize(self) -> bytes:
        out = b""
        out += encode_bytes_field(SUBMISSION_ACCOUNT_NAME, self.account_name)
        out += encode_bytes_field(SUBMISSION_UNIQUE_METHOD_NAME,
                                  self.unique_method_name)
        for a in self.authors:
            out += encode_bytes_field(SUBMISSION_AUTHORS, a)
        out += encode_bytes_field(SUBMISSION_AFFILIATION, self.affiliation)
        out += encode_bytes_field(SUBMISSION_DESCRIPTION, self.description)
        out += encode_bytes_field(SUBMISSION_METHOD_LINK, self.method_link)
        for sp in self.scenario_predictions:
            out += encode_message_field(SUBMISSION_SCENARIO_PREDICTIONS,
                                        sp.serialize())
        if self.uses_lidar_data:
            out += encode_bool_field(SUBMISSION_USES_LIDAR_DATA, True)
        if self.uses_camera_data:
            out += encode_bool_field(SUBMISSION_USES_CAMERA_DATA, True)
        if self.uses_public_model_pretraining:
            out += encode_bool_field(
                SUBMISSION_USES_PUBLIC_MODEL_PRETRAINING, True)
        return out


def quantize_waypoints(pred_waypoints) -> List[Waypoint]:
    """Quantize+compress one scenario's waypoint grids
    (inference.py:166-182). ``pred_waypoints`` is a WaypointGrids of
    [1, T, H, W, C] post-sigmoid arrays."""
    t = pred_waypoints.observed_occupancy.shape[1]
    out = []
    for k in range(t):
        obs = np.asarray(pred_waypoints.observed_occupancy[:, k])
        occ = np.asarray(pred_waypoints.occluded_occupancy[:, k])
        flow = np.asarray(pred_waypoints.flow[:, k])
        obs_q = np.round(obs * 255).astype(np.uint8)
        occ_q = np.round(occ * 255).astype(np.uint8)
        flow_q = np.clip(np.round(flow), -128, 127).astype(np.int8)
        out.append(Waypoint(
            observed_vehicles_occupancy=zlib.compress(obs_q.tobytes()),
            occluded_vehicles_occupancy=zlib.compress(occ_q.tobytes()),
            all_vehicles_flow=zlib.compress(flow_q.tobytes()),
        ))
    return out


def submission_shard_filename(test_shard_path: str) -> str:
    """'XXXXXnew.tfrecords' -> 'occupancy_flow_submission.binproto-XXXXX-of-00150'
    (inference.py:240-244)."""
    basename = os.path.basename(test_shard_path)
    if "new.tfrecords" not in basename:
        raise ValueError("Cannot determine file path for saving submission.")
    num = basename[:5]
    return f"occupancy_flow_submission.binproto-{num}-of-00150"


def save_submission(submission: ChallengeSubmission, save_dir: str,
                    test_shard_path: str) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, submission_shard_filename(test_shard_path))
    with open(path, "wb") as f:
        f.write(submission.serialize())
    return path
