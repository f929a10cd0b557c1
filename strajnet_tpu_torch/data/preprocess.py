"""Offline preprocessing: WOMD tf_example shards -> training TFRecords.

Counterpart of ``strajnet_tpu/data/preprocess.py`` (reference
data_preprocessing.py ``Processor``): per scenario it writes the record the
JAX ``Processor`` writes, byte for byte (the schema of
:mod:`strajnet_tpu_torch.data.schema`):

- 512^2 OGM history stack [512, 512, 11, 2] (vehicles | ped+cyc),
- 256^2 matplotlib map raster,
- nearest-48 observed + <=16 approaching-occluded actor tracks,
- <=256 centerline segments,
- historical backward-flow raster (vehicles / ped+cyc),
- 8 GT waypoint grids (observed/occupancy, flow, flow origin).

``process_scenario`` composes three parts, as the JAX one does:
:meth:`Processor.raster_features` (the OGM history, ``vec_flow``,
``byc_flow`` and the GT waypoint grids: tensor work on ``device``, the card
unless the CPU is asked for), :meth:`Processor.vector_features` (numpy) and
:meth:`Processor.map_image` (matplotlib, on the host). Reading and writing
shards needs TensorFlow, the map raster matplotlib; both load at first use,
and where one is missing the CLI raises ``ImportError``.

Usage (shards fan out over worker processes started by ``spawn``, which may
each use the card):
    python -m strajnet_tpu_torch.data.preprocess --file_dir .../tf_example \\
        --save_dir .../preprocessed_data --ids_dir .../challenge_ids \\
        --splits training validation --pool 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import multiprocessing
import os
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from strajnet_tpu_torch.config import (
    TaskConfig,
    WAYMO_OGM_TASK_CONFIG,
    WAYMO_TASK_CONFIG,
)
from strajnet_tpu_torch.data import raster
from strajnet_tpu_torch.data.map_raster import render_map_image
from strajnet_tpu_torch.data.schema import _tf, encode_example
from strajnet_tpu_torch.data.vectorize import (
    rotate_all_from_inputs,
    segment_centerlines,
    select_actors,
)
from strajnet_tpu_torch.data.womd import TYPE_CYCLIST, TYPE_PEDESTRIAN, \
    TYPE_VEHICLE, parse_womd_example
from strajnet_tpu_torch.device import resolve_device


class Processor:
    """Per-shard preprocessing pipeline (reference Processor parity)."""

    def __init__(self, max_actors: int = 48, max_occu: int = 16,
                 rasterisation_size: int = 256, save_dir: str = ".",
                 ids_dir: str = "",
                 config: TaskConfig = WAYMO_TASK_CONFIG,
                 ogm_config: TaskConfig = WAYMO_OGM_TASK_CONFIG,
                 device="cuda"):
        self.img_size = rasterisation_size
        self.max_actors = max_actors
        self.max_occu = max_occu
        self.save_dir = save_dir
        self.ids_dir = ids_dir
        self.config = config
        self.ogm_config = ogm_config
        self.device = resolve_device(device)

    def get_ids(self, val: bool = True) -> Set[str]:
        name = ("validation_scenario_ids.txt" if val
                else "testing_scenario_ids.txt")
        with open(os.path.join(self.ids_dir, name)) as f:
            return {line.strip() for line in f if line.strip()}

    def raster_features(self, rinputs: Dict[str, np.ndarray],
                        with_future: bool = True) -> Dict[str, np.ndarray]:
        """The 512^2 OGM history, the historical flows and (with the future)
        the GT waypoint grids, rendered on ``self.device``.

        The JAX Processor renders twice, without the future and with it; the
        current, past and historical-flow renders do not depend on it, so one
        render gives both."""
        grids = raster.create_timestep_grids(rinputs, self.ogm_config,
                                             with_future=with_future,
                                             device=self.device)
        past, cur = grids.past_occupancy, grids.current_occupancy
        veh_hist = torch.cat([past[TYPE_VEHICLE], cur[TYPE_VEHICLE]])
        ped_hist = torch.cat([
            torch.clamp(past[TYPE_PEDESTRIAN] + past[TYPE_CYCLIST], 0, 1),
            torch.clamp(cur[TYPE_PEDESTRIAN] + cur[TYPE_CYCLIST], 0, 1)])
        # [T, H, W] -> [H, W, T, 2]
        ogm = torch.stack([veh_hist.permute(1, 2, 0),
                           ped_hist.permute(1, 2, 0)], dim=-1).to(torch.bool)
        flow = grids.history_flow
        out = {
            "ogm": ogm,
            "vec_flow": flow[TYPE_VEHICLE][0],  # [H, W, 2]
            "byc_flow": flow[TYPE_PEDESTRIAN][0] + flow[TYPE_CYCLIST][0],
        }
        # GT waypoints (rendered at the 512^2 frame like the reference,
        # cropped to 256^2 by the online parser — train.py:93-99)
        if with_future:
            wp = raster.create_waypoint_grids(grids, self.config,
                                              obj_type=TYPE_VEHICLE)
            out["gt_obs_ogm"] = wp.observed_occupancy.to(torch.bool)
            out["gt_occ_ogm"] = wp.occluded_occupancy.to(torch.bool)
            out["gt_flow"] = wp.flow
            out["origin_flow"] = wp.flow_origin_occupancy
        return {k: v.cpu().numpy() for k, v in out.items()}

    def vector_features(self, rinputs: Dict[str, np.ndarray]
                        ) -> Tuple[Dict[str, np.ndarray], dict]:
        """Actor tracks and centerline segments in the 256^2 model frame
        (numpy), and the rotated scene the map raster draws."""
        rot = rotate_all_from_inputs(rinputs, self.config)
        actors, occl_actors = select_actors(
            rot, np.asarray(rinputs["state/type"]), self.max_actors,
            self.max_occu)
        centerlines = segment_centerlines(
            rot, np.asarray(rinputs["roadgraph_samples/type"]),
            np.asarray(rinputs["roadgraph_samples/id"]))
        return {"centerlines": centerlines.astype(np.float64),
                "actors": actors.astype(np.float64),
                "occl_actors": occl_actors.astype(np.float64)}, rot

    def map_image(self, parsed: Dict[str, np.ndarray], rot: dict
                  ) -> np.ndarray:
        """The map raster (matplotlib) with the current traffic lights."""
        lights_valid = np.where(
            np.asarray(parsed["traffic_light_state/current/valid"])[0] > 0)[0]
        lights = {
            "x": np.asarray(
                parsed["traffic_light_state/current/x"])[0, lights_valid],
            "y": np.asarray(
                parsed["traffic_light_state/current/y"])[0, lights_valid],
            "state": np.asarray(
                parsed["traffic_light_state/current/state"])[0, lights_valid],
        }
        return render_map_image(
            rot["xy_val"], np.asarray(parsed["roadgraph_samples/type"]),
            np.asarray(parsed["roadgraph_samples/id"]), rot["map_mask"],
            traffic_lights=lights, img_size=self.img_size).astype(np.int8)

    def process_scenario(self, parsed: Dict[str, np.ndarray],
                         with_future: bool = True) -> Dict[str, np.ndarray]:
        """One scenario -> the full output feature dict (numpy)."""
        # raster inputs (only the state/roadgraph fields the renderer needs)
        rinputs = {k: np.asarray(v) for k, v in parsed.items()
                   if k.startswith(("state/", "roadgraph_samples/"))}
        grids = self.raster_features(rinputs, with_future)
        vectors, rot = self.vector_features(rinputs)
        out = dict(vectors)
        out["ogm"] = grids.pop("ogm")
        out["map_image"] = self.map_image(parsed, rot)
        out.update(grids)
        return out

    def workflow(self, filename: str, pred: bool = False, val: bool = False):
        """Processes one WOMD shard -> one output TFRecord
        (reference data_preprocessing.py:383-448)."""
        tf = _tf()

        ids: Optional[Set[str]] = None
        split = "train"
        if pred:
            ids = self.get_ids(val=False)
            split = "test"
        elif val:
            ids = self.get_ids(val=True)
            split = "val"
        os.makedirs(os.path.join(self.save_dir, split), exist_ok=True)
        num = os.path.basename(filename).split("-")[1]
        out_path = os.path.join(self.save_dir, split,
                                f"{num}new.tfrecords")

        dataset = tf.data.TFRecordDataset(filename, compression_type="")
        count = 0
        with tf.io.TFRecordWriter(out_path) as writer:
            for record in dataset:
                parsed = parse_womd_example(record)
                sc_id = parsed["scenario/id"].numpy()[0]
                if isinstance(sc_id, bytes):
                    sc_id = sc_id.decode("utf-8")
                if ids is not None and sc_id not in ids:
                    continue
                np_parsed = {k: v.numpy() for k, v in parsed.items()
                             if k != "scenario/id"}
                feats = self.process_scenario(np_parsed,
                                              with_future=not pred)
                writer.write(encode_example(
                    feats,
                    scenario_id=sc_id if (pred or val) else None,
                    test=pred))
                count += 1
        print(f"{filename}: collect {count}")
        return count


def _process_one(filename: str, save_dir: str, ids_dir: str, split: str,
                 device: str = "cuda"):
    print("Working on", filename)
    processor = Processor(save_dir=save_dir, ids_dir=ids_dir, device=device)
    processor.workflow(filename, pred=(split == "testing"),
                       val=(split == "validation"))
    print(filename, "done!")


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Data preprocessing (PyTorch)")
    p.add_argument("--ids_dir", type=str,
                   default="./Waymo_Dataset/occupancy_flow_challenge/")
    p.add_argument("--save_dir", type=str,
                   default="./Waymo_Dataset/preprocessed_data/")
    p.add_argument("--file_dir", type=str,
                   default="./Waymo_Dataset/tf_example")
    p.add_argument("--pool", type=int, default=2)
    p.add_argument("--splits", nargs="+",
                   default=["training", "validation", "testing"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the rasterizer; 'cpu' only when "
                        "asked")
    args = p.parse_args(argv)
    resolve_device(args.device)
    # fail here, not in a worker, where a library the workers need is missing
    for name in ("tensorflow", "matplotlib"):
        if importlib.util.find_spec(name) is None:
            raise ImportError(f"the preprocessor needs {name}, which is not "
                              f"installed")

    # a forked child cannot use CUDA once its parent has: spawn them
    context = multiprocessing.get_context("spawn")
    for split in args.splits:
        files = sorted(glob.glob(f"{args.file_dir}/{split}/*"))
        print(f"Processing {split} data... {len(files)} found!")
        with context.Pool(args.pool) as pool:
            pool.starmap(_process_one,
                         [(f, args.save_dir, args.ids_dir, split,
                           args.device) for f in files])


if __name__ == "__main__":
    main()
