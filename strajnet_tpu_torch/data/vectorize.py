"""Vector-feature extraction: agent tracks, occluded candidates, centerlines.

Numpy host-side equivalents of the reference's ego-centric rotation +
selection logic (reference grid_utils.py:438-607,
data_preprocessing.py:145-260). Ragged/sorting logic stays on host — it runs
once per scenario in the offline pipeline.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from strajnet_tpu_torch.config import TaskConfig

OCCLUDED_MARGIN_CELLS = 64  # larger_box margin (grid_utils.py:53-58)


def _to_np(x):
    return np.asarray(x)


def rotate_all_from_inputs(inputs: Dict[str, np.ndarray],
                           config: TaskConfig):
    """Ego-centric rotation of roadgraph + agent tracks and FOV masks.

    Parity: reference grid_utils.py:438-584. Returns a dict with:
      xy_val       [R, 2]  roadgraph points in integer grid coords
      map_traj     [R, 4]  rotated (x, y) + raw (dx, dy) direction
      map_mask     [R]     in-FOV and valid
      actor_traj   [A, 11, 5]  (x, y, vx, vy, yaw) * valid
      in_box_mask  [A]     any history-step box corner inside strict FOV
      occu_mask    [A]     occluded candidate: inside larger box, not in FOV
      valid        [A, 11]
    """
    sdc_idx = int(np.argmax(_to_np(inputs["state/is_sdc"])))
    sdc_x = float(_to_np(inputs["state/current/x"])[sdc_idx, 0])
    sdc_y = float(_to_np(inputs["state/current/y"])[sdc_idx, 0])
    sdc_yaw = float(_to_np(inputs["state/current/bbox_yaw"])[sdc_idx, 0])
    angle = math.pi / 2 - sdc_yaw
    cos, sin = math.cos(angle), math.sin(angle)

    # --- roadgraph ---
    rg_xyz = _to_np(inputs["roadgraph_samples/xyz"])
    rg_x = rg_xyz[:, 0] - sdc_x
    rg_y = rg_xyz[:, 1] - sdc_y
    rg_dir = _to_np(inputs["roadgraph_samples/dir"])
    rg_valid = _to_np(inputs["roadgraph_samples/valid"])[:, 0] > 0
    if config.normalize_sdc_yaw:
        rg_x, rg_y = rg_x * cos - rg_y * sin, rg_x * sin + rg_y * cos

    gx, gy, in_fov = _grid_transform(rg_x, rg_y, config)
    map_mask = in_fov & rg_valid
    xy_val = np.stack([gx, gy], axis=-1)
    # NOTE parity: directions are NOT rotated (grid_utils.py:495 commented).
    map_traj = np.stack([rg_x, rg_y, rg_dir[:, 0], rg_dir[:, 1]], axis=-1)

    # --- agent tracks over past+current ---
    def hist(field):
        return np.concatenate([_to_np(inputs[f"state/past/{field}"]),
                               _to_np(inputs[f"state/current/{field}"])],
                              axis=1)

    x = hist("x") - sdc_x
    y = hist("y") - sdc_y
    vx, vy = hist("velocity_x"), hist("velocity_y")
    yaw = hist("bbox_yaw")
    length, width = hist("length"), hist("width")
    valid = hist("valid").astype(np.float32)

    x, y = x * cos - y * sin, x * sin + y * cos
    vx, vy = vx * cos - vy * sin, vx * sin + vy * cos

    # occluded candidates: current position inside the enlarged box
    _, _, pseudo_occu = _grid_transform(x[:, -1], y[:, -1], config,
                                        margin=OCCLUDED_MARGIN_CELLS)

    # strict-FOV membership of any of the 4 rotated bbox corners at any step
    corners = _rotate_box(x, y, length, width, yaw + angle)
    in_box_any = np.zeros(x.shape, bool)
    for cx, cy in corners:
        _, _, m = _grid_transform(cx, cy, config)
        in_box_any |= m
    in_box_mask = in_box_any.sum(axis=1) > 0

    occu_mask = pseudo_occu & ~in_box_mask

    # NOTE parity: yaw is kept in the original (un-rotated) frame
    # (grid_utils.py:580 leaves `bbox_yaw` without `+ angle`).
    actor_traj = valid[..., None] * np.stack([x, y, vx, vy, yaw], axis=-1)

    return dict(xy_val=xy_val, map_traj=map_traj, map_mask=map_mask,
                actor_traj=actor_traj, in_box_mask=in_box_mask,
                occu_mask=occu_mask, valid=valid)


def _grid_transform(px, py, config: TaskConfig, margin: int = 0):
    ppm = config.pixels_per_meter
    gx = np.round(px * ppm).astype(np.int64) + config.sdc_x_in_grid
    gy = np.round(-py * ppm).astype(np.int64) + config.sdc_y_in_grid
    ok = ((gx >= -margin) & (gx < config.grid_width_cells + margin) &
          (gy >= -margin) & (gy < config.grid_height_cells + margin))
    return gx, gy, ok


def _rotate_box(x, y, length, width, yaw):
    """4 box corners [(ul), (ur), (ll), (lr)] (grid_utils.py:587-607)."""
    s, c = np.sin(yaw), np.cos(yaw)
    out = []
    for fl, fw in ((0.5, -0.5), (0.5, 0.5), (-0.5, -0.5), (-0.5, 0.5)):
        cx = c * length * fl - s * width * fw + x
        cy = s * length * fl + c * width * fw + y
        out.append((cx, cy))
    return out


def select_actors(rot: Dict[str, np.ndarray], agent_type: np.ndarray,
                  max_actors: int = 48, max_occu: int = 16
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-K observed actors + approaching occluded candidates.

    Parity: reference data_preprocessing.py:145-213. Feature layout per
    step: 5 kinematic (x, y, vx, vy, yaw) + 3 one-hot type.
    """
    emb = np.eye(3)
    steps = rot["actor_traj"].shape[1]

    def one_hot(t):
        t = int(t)
        return emb[t - 1] if t in (1, 2, 3) else np.zeros(3)

    # observed: agents whose box touched the FOV; rank by last-valid pos norm
    sel = np.where(rot["in_box_mask"])[0]
    entries = []
    for i in sel:
        w = np.where(rot["valid"][i] > 0)[0]
        if w.size == 0:
            continue
        last = rot["actor_traj"][i, w[-1], :2]
        entries.append((np.linalg.norm(last), i))
    entries.sort(key=lambda e: e[0])
    output_actors = np.zeros((max_actors, steps, 8))
    for slot, (_, i) in enumerate(entries[:max_actors]):
        output_actors[slot] = np.concatenate(
            [rot["actor_traj"][i],
             np.tile(one_hot(agent_type[i]), (steps, 1))], axis=-1)

    # occluded candidates approaching the ego (begin_dist > last_dist)
    sel = np.where(rot["occu_mask"])[0]
    entries = []
    for i in sel:
        w = np.where(rot["valid"][i] > 0)[0]
        if w.size == 0:
            continue
        b, e = w[0], w[-1]
        begin = np.linalg.norm(rot["actor_traj"][i, b, :2])
        last = np.linalg.norm(rot["actor_traj"][i, e, :2])
        if begin <= last:
            continue
        entries.append((last, i))
    entries.sort(key=lambda e: e[0])
    output_occu = np.zeros((max_occu, steps, 8))
    for slot, (_, i) in enumerate(entries[:max_occu]):
        output_occu[slot] = np.concatenate(
            [rot["actor_traj"][i],
             np.tile(one_hot(agent_type[i]), (steps, 1))], axis=-1)

    return output_actors, output_occu


def segment_centerlines(rot: Dict[str, np.ndarray],
                        rg_type: np.ndarray, rg_id: np.ndarray,
                        num_segs: int = 256, seg_length: int = 10
                        ) -> np.ndarray:
    """Splits valid centerlines into <=num_segs 10-point segments of
    4 geometry + 3 one-hot type features.

    Parity: reference data_preprocessing.py:215-260 (types {1,2,3,18};
    {1,2} -> [1,0,0], {3} -> [0,1,0], {18} -> [0,0,1]).
    """
    valid = rot["map_mask"]
    xyz = rot["map_traj"][valid]
    types = rg_type.reshape(-1)[valid]
    ids = rg_id.reshape(-1)[valid]

    res = []
    count = 0
    for uid in np.unique(ids):
        mask = np.where(ids == uid)[0]
        way_type = int(types[mask][0])
        if way_type not in (1, 2, 3, 18):
            continue
        if way_type in (1, 2):
            emb_type = [1, 0, 0]
        elif way_type == 3:
            emb_type = [0, 1, 0]
        else:
            emb_type = [0, 0, 1]
        traj = xyz[mask]
        n = traj.shape[0]
        pad = seg_length - n % seg_length
        traj = np.concatenate(
            [np.concatenate([traj, np.tile(emb_type, (n, 1))], axis=-1),
             np.zeros((pad, 7))], axis=0).reshape(-1, seg_length, 7)
        count += traj.shape[0]
        res.append(traj)
        if count > num_segs:
            break
    if not res:
        return np.zeros((num_segs, seg_length, 7))
    res = np.concatenate(res, axis=0)[:num_segs]
    if res.shape[0] < num_segs:
        res = np.concatenate(
            [res, np.zeros((num_segs - res.shape[0], seg_length, 7))],
            axis=0)
    return res
