"""Occupancy and flow rasterization of WOMD scenarios, in PyTorch.

Counterpart of ``strajnet_tpu/data/raster.py``: every function keeps its
name and semantics, and its grids equal the JAX package's bit for bit. The
scenario is a dict of numpy arrays (or tensors) keyed as a parsed WOMD
``tf_example``; each function runs on the device it is given, the card
unless the caller asks for the CPU.

Three things make the grids exact, and the same on the card as on the CPU:

- Fields are narrowed as JAX stores them with 64-bit types off (float64 to
  float32, int64 to int32) before any arithmetic, and every float32
  operation is the JAX expression's, in its order.
- The reference is the rasterizer as the JAX ``Processor`` runs it, jitted
  on XLA's CPU backend. That backend takes sine and cosine from the C
  library and fuses the first product of ``x * cos - y * sin``, ``x * sin +
  y * cos`` and the two box-point sums into one multiply-add; eager JAX
  rounds every product and moves a few box points a scenario to another
  cell. ``core/libm.py`` computes both as XLA does, from basic float64
  operations.
- The scatter-adds (``.at[lin].add``) become ``index_put_`` (occupancy: a
  cell is 1 where any kept point lands) and ``index_add_`` (flow) over the
  kept points only. Those lie in view, so the clip of the JAX index is a
  no-op for them. Every flow sum is of integers far below 2**24, exact in
  float32 in any order, so the card's atomics give the CPU's sums.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from strajnet_tpu_torch.config import TaskConfig
from strajnet_tpu_torch.core.libm import cosf, fmaf, sinf
from strajnet_tpu_torch.data.womd import (
    ALL_AGENT_TYPES,
    NUM_FUTURE_STEPS,
    NUM_PAST_STEPS,
)
from strajnet_tpu_torch.device import resolve_device

NUM_HISTORY_STEPS = NUM_PAST_STEPS + 1  # past + current
NUM_ALL_STEPS = NUM_PAST_STEPS + 1 + NUM_FUTURE_STEPS  # 91

Device = Union[str, torch.device]
Scenario = Dict[str, Union[np.ndarray, torch.Tensor]]

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _field(value, device: torch.device) -> torch.Tensor:
    """One scenario field on ``device``, narrowed as ``jnp.asarray``
    narrows it with 64-bit types off."""
    t = torch.as_tensor(value)
    return t.to(_NARROW.get(t.dtype, t.dtype)).to(device)


def stack_history(inputs: Scenario, times, field,
                  device: Device = "cuda") -> torch.Tensor:
    """Concat state/{time}/{field} along the step axis -> [A, steps]."""
    device = resolve_device(device)
    return torch.cat([_field(inputs[f"state/{t}/{field}"], device)
                      for t in times], dim=-1)


class SampledPoints(NamedTuple):
    x: torch.Tensor           # [A, T, P] ego-frame meters
    y: torch.Tensor
    valid: torch.Tensor       # [A, T, P] bool
    agent_type: torch.Tensor  # [A, T, P] int32


def _unit_box_points(pps_length: int, pps_width: int) -> Tuple[np.ndarray,
                                                               np.ndarray]:
    """P = pps_length*pps_width unit-square sample offsets in [-0.5, 0.5]."""
    sl = 0.0 if pps_length == 1 else 1.0 / (pps_length - 1)
    sw = 0.0 if pps_width == 1 else 1.0 / (pps_width - 1)
    xi = np.arange(pps_length) * sl - (0.5 if pps_length > 1 else 0.0)
    yi = np.arange(pps_width) * sw - (0.5 if pps_width > 1 else 0.0)
    ux, uy = np.meshgrid(xi, yi, indexing="ij")
    return ux.reshape(-1).astype(np.float32), uy.reshape(-1).astype(
        np.float32)


def ego_frame_fields(inputs: Scenario, times, config: TaskConfig,
                     device: Device = "cuda"):
    """Agent box fields translated/rotated into the ego frame.

    Returns x, y, bbox_yaw, length, width, valid — all [A, steps].
    """
    device = resolve_device(device)
    x = stack_history(inputs, times, "x", device)
    y = stack_history(inputs, times, "y", device)
    bbox_yaw = stack_history(inputs, times, "bbox_yaw", device)
    length = stack_history(inputs, times, "length", device)
    width = stack_history(inputs, times, "width", device)
    valid = stack_history(inputs, times, "valid", device).to(torch.int32)

    # the first maximum, as jnp.argmax; a 0-d index keeps the host out
    sdc_idx = torch.argmax(_field(inputs["state/is_sdc"], device))
    sdc_x = _field(inputs["state/current/x"], device)[sdc_idx, 0]
    sdc_y = _field(inputs["state/current/y"], device)[sdc_idx, 0]
    sdc_yaw = _field(inputs["state/current/bbox_yaw"], device)[sdc_idx, 0]

    x = x - sdc_x
    y = y - sdc_y
    if config.normalize_sdc_yaw:
        angle = math.pi / 2 - sdc_yaw
        cos, sin = cosf(angle), sinf(angle)
        # x * cos - y * sin and x * sin + y * cos, the first product fused
        x, y = fmaf(x, cos, -(y * sin)), fmaf(x, sin, y * cos)
        bbox_yaw = bbox_yaw + angle
    return x, y, bbox_yaw, length, width, valid


def sample_agent_points(inputs: Scenario, times, config: TaskConfig,
                        device: Device = "cuda") -> SampledPoints:
    """Densely samples points from rotated agent boxes: [A, T, P] fields."""
    device = resolve_device(device)
    x, y, bbox_yaw, length, width, valid = ego_frame_fields(inputs, times,
                                                            config, device)
    ux, uy = _unit_box_points(config.agent_points_per_side_length,
                              config.agent_points_per_side_width)
    ux = torch.from_numpy(ux).to(device)[None, None, :]
    uy = torch.from_numpy(uy).to(device)[None, None, :]
    sin = sinf(bbox_yaw)[..., None]
    cos = cosf(bbox_yaw)[..., None]
    l = length[..., None]
    w = width[..., None]
    # cos * l * ux - sin * w * uy + x, and sin * l * ux + cos * w * uy + y,
    # the product with ux fused
    px = fmaf(cos * l, ux, -(sin * w * uy)) + x[..., None]
    py = fmaf(sin * l, ux, cos * w * uy) + y[..., None]
    p = ux.shape[-1]
    a, t = x.shape
    valid_p = (valid > 0)[..., None].expand(a, t, p)
    atype = _field(inputs["state/type"], device).to(torch.int32)[
        :, None, None].expand(a, t, p)
    return SampledPoints(px, py, valid_p, atype)


def to_grid(points_x, points_y, config: TaskConfig):
    """World(ego)-meters -> integer grid cells + in-FOV mask
    (grid_utils.py:18-60 semantics)."""
    ppm = config.pixels_per_meter
    gx = torch.round(points_x * ppm).to(torch.int32) + config.sdc_x_in_grid
    gy = torch.round(-points_y * ppm).to(torch.int32) + config.sdc_y_in_grid
    in_fov = ((gx >= 0) & (gx < config.grid_width_cells) &
              (gy >= 0) & (gy < config.grid_height_cells))
    return gx, gy, in_fov


def _observation_mask(inputs: Scenario, include_observed: bool,
                      include_occluded: bool, device: torch.device
                      ) -> Optional[torch.Tensor]:
    """[A, 1] agent filter. 'Observed' = valid at ANY history step (past or
    current); 'occluded' = its complement (the JAX function's docstring
    gives the derivation)."""
    if include_observed and include_occluded:
        return None
    hist_valid = stack_history(inputs, ["past", "current"], "valid", device)
    observed = torch.amax(hist_valid, dim=1, keepdim=True) > 0
    if include_observed:
        return observed
    if include_occluded:
        return torch.logical_not(observed)
    raise ValueError("must include observed and/or occluded")


def _cells(gx, gy, config: TaskConfig) -> torch.Tensor:
    """Flat [T, H, W] cell of each in-view point: int64 (a tensor of 91 x
    512 x 512 cells wants 64-bit indices)."""
    h, w = config.grid_height_cells, config.grid_width_cells
    t_idx = torch.arange(gx.shape[1], device=gx.device, dtype=torch.int64)[
        None, :, None]
    return (t_idx * h + gy.to(torch.int64)) * w + gx.to(torch.int64)


def render_occupancy(inputs: Scenario, times, config: TaskConfig,
                     include_observed: bool = True,
                     include_occluded: bool = True,
                     device: Device = "cuda") -> Dict[int, torch.Tensor]:
    """Per-class binary occupancy grids [T, H, W] (values in {0, 1})."""
    device = resolve_device(device)
    pts = sample_agent_points(inputs, times, config, device)
    gx, gy, in_fov = to_grid(pts.x, pts.y, config)
    keep = pts.valid & in_fov
    mask = _observation_mask(inputs, include_observed, include_occluded,
                             device)
    if mask is not None:
        keep = keep & mask[:, :, None]

    t = gx.shape[1]
    h, w = config.grid_height_cells, config.grid_width_cells
    lin = _cells(gx, gy, config)
    out = {}
    for obj_type in ALL_AGENT_TYPES:
        sel = keep & (pts.agent_type == obj_type)
        grid = torch.zeros(t * h * w, dtype=torch.float32, device=device)
        grid[lin[sel]] = 1.0
        out[obj_type] = grid.view(t, h, w)
    return out


def render_backward_flow(inputs: Scenario, times, config: TaskConfig,
                         waypoint_size: int, include_observed: bool = True,
                         include_occluded: bool = True,
                         device: Device = "cuda"
                         ) -> Dict[int, torch.Tensor]:
    """Per-class backward flow [T - waypoint_size, H, W, 2].

    flow[i] at the position of step ``i + waypoint_size`` holds the
    grid-units displacement back to step ``i`` (dx, dy) = earlier - later,
    averaged per pixel over contributing points.
    """
    device = resolve_device(device)
    pts = sample_agent_points(inputs, times, config, device)
    gx, gy, in_fov = to_grid(pts.x, pts.y, config)
    # Flow requires valid boxes at both endpoints; scatter at the later one.
    later = slice(waypoint_size, None)
    earlier = slice(None, -waypoint_size)
    keep = (pts.valid[:, later] & pts.valid[:, earlier] & in_fov[:, later])
    mask = _observation_mask(inputs, include_observed, include_occluded,
                             device)
    if mask is not None:
        keep = keep & mask[:, :, None]

    gxl, gyl = gx[:, later], gy[:, later]
    t = gxl.shape[1]
    h, w = config.grid_height_cells, config.grid_width_cells
    lin = _cells(gxl, gyl, config)
    # (dx, dy, 1) per point, summed per cell
    src = torch.stack([gx[:, earlier] - gxl, gy[:, earlier] - gyl,
                       torch.ones_like(gxl)], dim=-1).to(torch.float32)
    out = {}
    for obj_type in ALL_AGENT_TYPES:
        sel = keep & (pts.agent_type[:, later] == obj_type)
        sums = torch.zeros(t * h * w, 3, dtype=torch.float32, device=device)
        sums.index_add_(0, lin[sel], src[sel])
        cnt = sums[:, 2:]
        denom = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
        out[obj_type] = (sums[:, :2] / denom).view(t, h, w, 2)
        del sums  # before the next class's buffer
    return out


class TimestepGrids(NamedTuple):
    """Per-class topdown renders over time (waymo TimestepGrids parity).

    Class keys are womd TYPE_* ints; grids are [T, H, W] (occupancy) or
    [T, H, W, 2] (flow), tensors on the device they were rendered on.
    """

    current_occupancy: Dict[int, torch.Tensor]
    past_occupancy: Dict[int, torch.Tensor]
    future_observed_occupancy: Dict[int, torch.Tensor]
    future_occluded_occupancy: Dict[int, torch.Tensor]
    all_occupancy: Dict[int, torch.Tensor]   # past+current+future, all agents
    all_flow: Dict[int, torch.Tensor]        # [91 - ws, H, W, 2]
    history_flow: Dict[int, torch.Tensor]    # [1, H, W, 2] past[0] -> current


class WaypointArrays(NamedTuple):
    """Stacked GT waypoint grids for one agent class ([T_wp, H, W, ...])."""

    observed_occupancy: torch.Tensor
    occluded_occupancy: torch.Tensor
    flow: torch.Tensor
    flow_origin_occupancy: torch.Tensor


def create_timestep_grids(inputs: Scenario, config: TaskConfig,
                          with_future: bool = True,
                          device: Device = "cuda") -> TimestepGrids:
    device = resolve_device(device)
    waypoint_size = config.num_future_steps // config.num_waypoints
    current = render_occupancy(inputs, ["current"], config, device=device)
    past = render_occupancy(inputs, ["past"], config, device=device)
    history_flow = render_backward_flow(inputs, ["past", "current"], config,
                                        waypoint_size=NUM_PAST_STEPS,
                                        device=device)
    if not with_future:
        empty = {k: None for k in ALL_AGENT_TYPES}
        return TimestepGrids(current, past, empty, empty, empty, empty,
                             history_flow)

    future_obs = render_occupancy(inputs, ["future"], config,
                                  include_observed=True,
                                  include_occluded=False, device=device)
    future_occ = render_occupancy(inputs, ["future"], config,
                                  include_observed=False,
                                  include_occluded=True, device=device)
    all_occ = render_occupancy(inputs, ["past", "current", "future"], config,
                               device=device)
    all_flow = render_backward_flow(inputs, ["past", "current", "future"],
                                    config, waypoint_size=waypoint_size,
                                    device=device)
    return TimestepGrids(current, past, future_obs, future_occ, all_occ,
                         all_flow, history_flow)


def create_waypoint_grids(grids: TimestepGrids, config: TaskConfig,
                          obj_type: int = 1) -> WaypointArrays:
    """GT waypoint grids for one agent class (waymo
    create_ground_truth_waypoint_grids parity, non-cumulative and cumulative).

    Waypoint k (0-based) ends at future step (k+1)*waypoint_size:
    - observed/occluded occupancy: future render at that step
      (max-pooled over the waypoint window if cumulative_waypoints);
    - flow: all_flow entry landing on that global step (displacement over
      waypoint_size steps);
    - flow_origin_occupancy: all-agent occupancy of this class one
      waypoint_size earlier.
    """
    ws = config.num_future_steps // config.num_waypoints
    n = config.num_waypoints
    fo = grids.future_observed_occupancy[obj_type]
    fc = grids.future_occluded_occupancy[obj_type]
    ao = grids.all_occupancy[obj_type]
    af = grids.all_flow[obj_type]

    obs, occ, flow, origin = [], [], [], []
    for k in range(n):
        end = (k + 1) * ws  # future-relative, 1-based step index
        if config.cumulative_waypoints:
            window = slice(k * ws, (k + 1) * ws)
            obs.append(torch.amax(fo[window], dim=0))
            occ.append(torch.amax(fc[window], dim=0))
        else:
            obs.append(fo[end - 1])
            occ.append(fc[end - 1])
        # all_flow index i lands at global step i + ws; waypoint end's global
        # step is NUM_HISTORY_STEPS - 1 + end.
        flow.append(af[NUM_HISTORY_STEPS - 1 + end - ws])
        # origin: global step (NUM_HISTORY_STEPS - 1 + end) - ws.
        origin.append(ao[NUM_HISTORY_STEPS - 1 + end - ws])

    return WaypointArrays(
        observed_occupancy=torch.stack(obs)[..., None],
        occluded_occupancy=torch.stack(occ)[..., None],
        flow=torch.stack(flow),
        flow_origin_occupancy=torch.stack(origin)[..., None],
    )
