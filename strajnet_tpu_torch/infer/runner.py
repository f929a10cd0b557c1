"""Inference / submission CLI.

Counterpart of ``strajnet_tpu/infer/runner.py``. Usage:

    python -m strajnet_tpu_torch.infer.runner --ids_dir ... --save_dir ... \\
        --file_dir ... --weight_path weights.pt

``--weight_path`` takes a ``.pt`` state dict, for example one written by
``tools/flax_to_torch.py`` from a checkpoint of the JAX package. The model
runs on ``--device`` (default ``cuda``); a device that is not there raises.
"""

from __future__ import annotations

import argparse
import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional, Sequence, Set

import numpy as np
import torch
from torch import nn

from strajnet_tpu_torch.config import STRAJNET_CONFIG
from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.infer.submission import (
    ChallengeSubmission,
    ScenarioPrediction,
    quantize_waypoints,
    save_submission,
)
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params
from strajnet_tpu_torch.objective.loss import WaypointGrids
from strajnet_tpu_torch.train.step import make_predict_step

_ID_KEY = "scenario/id"


def load_scenario_ids(ids_dir: str, test: bool = True) -> Set[str]:
    """Challenge scenario-id whitelist."""
    name = ("testing_scenario_ids.txt" if test
            else "validation_scenario_ids.txt")
    with open(os.path.join(ids_dir, name)) as f:
        ids = {line.strip() for line in f if line.strip()}
    print(f"original ids num:{len(ids)}")
    return ids


def _tfrecord_batches(shard_path: str, batch_size: int,
                      compact: bool) -> Iterable[Dict[str, np.ndarray]]:
    # TensorFlow is needed only to read real shards, so it loads here.
    from strajnet_tpu_torch.data.pipeline import as_numpy, make_test_dataset

    return as_numpy(make_test_dataset(shard_path, batch_size=batch_size,
                                      compact=compact))


def run_shard(model: nn.Module, predict_step: Callable, shard_path: str,
              ids: Optional[Set[str]], save_dir: str, batch_size: int = 16,
              compact: bool = True,
              batches: Optional[Iterable[Dict[str, np.ndarray]]] = None
              ) -> int:
    """Predicts one test shard and writes its submission binproto.

    ``batches`` are dicts of numpy arrays with the parsed-TFRecord keys plus
    ``scenario/id``; by default they are read from ``shard_path``, which
    also names the output file. Each batch goes to the model's device in one
    copy and comes back in one fetch; per-scenario quantization (24 zlib
    compressions each) runs on a thread pool, since zlib releases the GIL.
    Returns the number of scenarios written.
    """
    if batches is None:
        batches = _tfrecord_batches(shard_path, batch_size, compact)
    device = next(model.parameters()).device
    print(f"Creating submission for test shard "
          f"{os.path.basename(shard_path)}...")
    submission = ChallengeSubmission()
    count = 0
    for batch in batches:
        sc_ids = [s.decode("utf-8") if isinstance(s, bytes) else str(s)
                  for s in batch[_ID_KEY]]
        if ids is not None:
            unknown = [s for s in sc_ids if s not in ids]
            if unknown:
                raise ValueError(f"scenario ids not in the whitelist: "
                                 f"{unknown[:5]}")
        tbatch = {k: torch.from_numpy(np.asarray(v)).to(device)
                  for k, v in batch.items() if k != _ID_KEY}
        pred = predict_step(model, tbatch)
        pred_np = WaypointGrids(*(a.cpu().numpy() for a in pred))

        def _quantize(i):
            return quantize_waypoints(
                WaypointGrids(*(a[i:i + 1] for a in pred_np)))

        with ThreadPoolExecutor(max_workers=8) as ex:
            waypoint_lists = list(ex.map(_quantize, range(len(sc_ids))))
        for sc_id, wps in zip(sc_ids, waypoint_lists):
            submission.scenario_predictions.append(ScenarioPrediction(
                scenario_id=sc_id, waypoints=wps))
            count += 1
    path = save_submission(submission, save_dir, shard_path)
    print(f"Saving {count} scenario predictions to {path}...")
    return count


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="STrajNet inference (PyTorch)")
    p.add_argument("--ids_dir", type=str,
                   default="./Waymo_Dataset/occupancy_flow_challenge/")
    p.add_argument("--save_dir", type=str,
                   default="./Waymo_Dataset/inference/")
    p.add_argument("--file_dir", type=str,
                   default="./Waymo_Dataset/preprocessed_data/test/")
    p.add_argument("--weight_path", type=str, default="",
                   help=".pt state dict (tools/flax_to_torch.py converts a "
                        "checkpoint of the JAX package)")
    p.add_argument("--no_id_check", action="store_true")
    p.add_argument("--batch_size", type=int, default=16,
                   help="scenarios per device batch")
    p.add_argument("--no_compact", action="store_true",
                   help="feed f32 from the host instead of uint8/f16")
    p.add_argument("--split", type=str, default="test",
                   choices=["test", "val"],
                   help="scenario-id whitelist to validate against")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model; 'cpu' only when asked")
    args = p.parse_args(argv)

    cfg = STRAJNET_CONFIG
    device = resolve_device(args.device)
    model = STrajNet(cfg)
    if args.weight_path:
        state = torch.load(args.weight_path, map_location="cpu",
                           weights_only=True)
        model.load_state_dict(state)
        print(f"loaded weights from {args.weight_path}")
    else:
        model.load_state_dict(init_params(cfg,
                                          torch.Generator().manual_seed(0)))
    model = model.to(device).eval()
    predict_step = make_predict_step(cfg.num_waypoints)

    ids = (None if args.no_id_check
           else load_scenario_ids(args.ids_dir, test=args.split == "test"))
    shards = sorted(glob.glob(os.path.join(args.file_dir, "*.tfrecords")))
    print(f"{len(shards)} found, start loading dataset")
    total = 0
    for shard in shards:
        total += run_shard(model, predict_step, shard, ids, args.save_dir,
                           batch_size=args.batch_size,
                           compact=not args.no_compact)
    print(total)


if __name__ == "__main__":
    main()
