"""The input pool: synthetic scenes at the parsed record's shapes, made on
the device from the run's seed.

The scenes follow the program's synthetic batches (four moving box agents
per scene in the OGM history and its flow, their future boxes in the
observed-occupancy and flow grids, their origins in the flow-origin grid; a
uniform map raster; four observed and one occluded actor track; half the
centerline segments), drawn here with ``torch`` on the device instead of
NumPy on the host. :func:`draws` makes the random numbers, :func:`render`
paints them; a CPU test holds :func:`render` against a loop that paints one
box at a time.
"""

from __future__ import annotations

from typing import Dict

import torch

AGENTS = 4


def with_sizes(cfg: dict) -> dict:
    """The configuration with the raster sides the scenes need: the map at
    half the OGM's side (``large_input``), the output grid at the
    bottleneck's side times two per decoder stage."""
    stages = len(cfg["depths"])
    bottleneck = cfg["input_size"][0] // cfg["patch_size"] // 2 ** (
        stages - 1) // 2
    return dict(cfg, map_size=cfg["input_size"][0] // 2,
                output_size=bottleneck * 2 ** (stages + 1))


def draws(cfg: dict, batch: int, g: torch.Generator, device
          ) -> Dict[str, torch.Tensor]:
    """Every random number of one batch, from ``g``."""
    oh = cfg["output_size"]
    box = max(2, oh // 32)

    def ints(low, high, *shape):
        return torch.randint(low, high, shape, device=device, generator=g)

    def normal(*shape):
        return torch.randn(shape, device=device, generator=g)

    return dict(
        y=ints(box, oh - 2 * box, batch, AGENTS),
        x=ints(box, oh - 2 * box, batch, AGENTS),
        vy=ints(-2, 3, batch, AGENTS), vx=ints(-2, 3, batch, AGENTS),
        map_image=torch.rand((batch, cfg["map_size"], cfg["map_size"], 3),
                             device=device, generator=g),
        actors=normal(batch, AGENTS, cfg["actor_steps"], cfg["actor_feats"]),
        occl=normal(batch, 1, cfg["actor_steps"], cfg["actor_feats"]),
        centerlines=normal(batch, cfg["map_segments"] // 2, cfg["map_points"],
                           cfg["map_feats"]))


def _boxes(top, left, size: int, side: int) -> torch.Tensor:
    """``[..., side, side]`` bool: the ``size`` x ``size`` box at each
    (top, left) of the leading shape."""
    ar = torch.arange(side, device=top.device)
    rows = (ar >= top[..., None]) & (ar < top[..., None] + size)
    cols = (ar >= left[..., None]) & (ar < left[..., None] + size)
    return rows[..., :, None] & cols[..., None, :]


def render(cfg: dict, d: Dict[str, torch.Tensor], train: bool
           ) -> Dict[str, torch.Tensor]:
    """A batch with the record's keys, float32, from :func:`draws`; the
    ground-truth grids only where ``train``."""
    b = d["y"].shape[0]
    h, oh, t = cfg["input_size"][0], cfg["output_size"], cfg["num_waypoints"]
    box = max(2, oh // 32)
    dev = d["y"].device
    off = (h - oh) // 2
    hist = _boxes(d["y"] + off, d["x"] + off, box, h)          # [B, A, h, h]
    ogm = torch.zeros(b, h, h, cfg["ogm_past_steps"], cfg["ogm_classes"],
                      device=dev)
    ogm[..., 0] = hist.any(dim=1)[..., None].float()
    vec_flow = torch.zeros(b, h, h, 2, device=dev)
    for a in range(AGENTS):     # a later agent paints over an earlier one
        v = torch.stack((d["vx"][:, a], d["vy"][:, a]), -1).float()
        vec_flow = torch.where(hist[:, a, ..., None], v[:, None, None],
                               vec_flow)
    actors = torch.zeros(b, cfg["obs_actors"], cfg["actor_steps"],
                         cfg["actor_feats"], device=dev)
    actors[:, :AGENTS] = d["actors"]
    occl = torch.zeros(b, cfg["occ_actors"], cfg["actor_steps"],
                       cfg["actor_feats"], device=dev)
    occl[:, :1] = d["occl"]
    lines = torch.zeros(b, cfg["map_segments"], cfg["map_points"],
                        cfg["map_feats"], device=dev)
    lines[:, :cfg["map_segments"] // 2] = d["centerlines"]
    out = dict(ogm=ogm, map_image=d["map_image"], actors=actors,
               occl_actors=occl, centerlines=lines, vec_flow=vec_flow)
    if not train:
        return out
    k = torch.arange(1, t + 1, device=dev)[:, None]           # [T, 1]
    yy = torch.clamp(d["y"][:, None] + d["vy"][:, None] * k, 0, oh - box)
    xx = torch.clamp(d["x"][:, None] + d["vx"][:, None] * k, 0, oh - box)
    fut = _boxes(yy, xx, box, oh)                          # [B, T, A, oh, oh]
    gt_flow = torch.zeros(b, t, oh, oh, 2, device=dev)
    for a in range(AGENTS):
        v = -torch.stack((d["vx"][:, a], d["vy"][:, a]), -1).float()
        gt_flow = torch.where(fut[:, :, a, ..., None],
                              v[:, None, None, None], gt_flow)
    origin = _boxes(d["y"], d["x"], box, oh).any(dim=1)    # [B, oh, oh]
    out.update(
        gt_obs_ogm=fut.any(dim=2)[..., None].float(),
        gt_occ_ogm=torch.zeros(b, t, oh, oh, 1, device=dev),
        gt_flow=gt_flow,
        origin_flow=origin[:, None, ..., None].expand(
            b, t, oh, oh, 1).float().contiguous())
    return out


def make_pool(cfg: dict, batch: int, size: int, seed: int, device,
              train: bool):
    """``size`` distinct batches from ``seed``, resident on ``device``."""
    g = torch.Generator(device).manual_seed(seed)
    return [render(cfg, draws(cfg, batch, g, device), train)
            for _ in range(size)]


def nbytes(batches) -> int:
    return sum(v.numel() * v.element_size() for b in batches
               for v in b.values())
