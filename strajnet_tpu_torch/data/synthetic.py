"""Synthetic batches with the exact parsed-TFRecord shapes (train.py:85-103).

Used by the minimum end-to-end training slice, the benchmark, and the
multi-chip dry run. Scenes contain a few moving box agents so losses,
flow-warp terms and metrics all exercise non-degenerate paths.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from strajnet_tpu_torch.config import ModelConfig


def synthetic_batch(cfg: ModelConfig, batch: int, seed: int = 0,
                    np_dtype=np.float32) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    h, w = cfg.input_size
    oh, ow = cfg.output_size
    t = cfg.num_waypoints

    ogm = np.zeros((batch, h, w, cfg.ogm_past_steps, cfg.ogm_classes),
                   np_dtype)
    gt_obs = np.zeros((batch, t, oh, ow, 1), np_dtype)
    gt_occ = np.zeros((batch, t, oh, ow, 1), np_dtype)
    gt_flow = np.zeros((batch, t, oh, ow, 2), np_dtype)
    origin_flow = np.zeros((batch, t, oh, ow, 1), np_dtype)
    vec_flow = np.zeros((batch, h, w, 2), np_dtype)

    n_agents = 4
    box = max(2, oh // 32)
    for b in range(batch):
        for _ in range(n_agents):
            y = rng.randint(box, oh - 2 * box)
            x = rng.randint(box, ow - 2 * box)
            vy, vx = rng.randint(-2, 3, size=2)
            # history in the 512-grid OGM (center-aligned with output grid)
            cy, cx = (h - oh) // 2 + y, (w - ow) // 2 + x
            ogm[b, cy:cy + box, cx:cx + box, :, 0] = 1.0
            vec_flow[b, cy:cy + box, cx:cx + box, 0] = vx
            vec_flow[b, cy:cy + box, cx:cx + box, 1] = vy
            for k in range(t):
                yy = np.clip(y + vy * (k + 1), 0, oh - box)
                xx = np.clip(x + vx * (k + 1), 0, ow - box)
                gt_obs[b, k, yy:yy + box, xx:xx + box, 0] = 1.0
                gt_flow[b, k, yy:yy + box, xx:xx + box, 0] = -vx
                gt_flow[b, k, yy:yy + box, xx:xx + box, 1] = -vy
                origin_flow[b, k, y:y + box, x:x + box, 0] = 1.0

    map_img = rng.rand(batch, *cfg.map_size, 3).astype(np_dtype)

    actors = np.zeros((batch, cfg.obs_actors, cfg.actor_steps,
                       cfg.actor_feats), np_dtype)
    actors[:, :n_agents] = rng.randn(batch, n_agents, cfg.actor_steps,
                                     cfg.actor_feats)
    occl = np.zeros((batch, cfg.occ_actors, cfg.actor_steps,
                     cfg.actor_feats), np_dtype)
    occl[:, :1] = rng.randn(batch, 1, cfg.actor_steps, cfg.actor_feats)

    centerlines = np.zeros((batch, cfg.map_segments, cfg.map_points,
                            cfg.map_feats), np_dtype)
    centerlines[:, : cfg.map_segments // 2] = rng.randn(
        batch, cfg.map_segments // 2, cfg.map_points, cfg.map_feats)

    return {
        "ogm": ogm,
        "map_image": map_img,
        "actors": actors,
        "occl_actors": occl,
        "centerlines": centerlines,
        "vec_flow": vec_flow,
        "gt_obs_ogm": gt_obs,
        "gt_occ_ogm": gt_occ,
        "gt_flow": gt_flow,
        "origin_flow": origin_flow,
    }
