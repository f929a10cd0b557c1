"""Challenge-metric evaluation over a preprocessed val split.

Counterpart of ``strajnet_tpu/infer/evaluate.py``. Usage:

    python -m strajnet_tpu_torch.infer.evaluate --file_dir .../preprocessed_data \\
        --weight_path weights.pt --batch_size 16 --pallas attn

``--weight_path`` takes a checkpoint directory of the training loop (the
newest checkpoint in it, through ``CheckpointManager.restore_params``) or a
``.pt`` state dict, for example one written by ``tools/flax_to_torch.py`` from
a checkpoint of the JAX package; without it the weights are drawn from seed
0. ``--pallas`` picks the Swin blocks' kernel mode as the JAX CLI does (auto |
off | attn | block | block_fwd). The model runs on ``--device`` (default
``cuda``); a device that is not there raises. Like the JAX CLI it builds
``STRAJNET_CONFIG``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from strajnet_tpu_torch.config import (STRAJNET_CONFIG, WAYMO_TASK_CONFIG,
                                       LossConfig)
from strajnet_tpu_torch.data.pipeline import prefetch_to_device
from strajnet_tpu_torch.device import resolve_device
from strajnet_tpu_torch.models.strajnet import (PALLAS_MODES, STrajNet,
                                                init_params)
from strajnet_tpu_torch.objective.metrics import (MetricsAccumulator,
                                                  print_metrics)
from strajnet_tpu_torch.train.checkpoints import load_weights
from strajnet_tpu_torch.train.step import make_eval_step

def _tfrecord_batches(file_pattern: str, batch_size: int,
                      compact: bool) -> Iterable[Dict[str, np.ndarray]]:
    # TensorFlow is needed only to read real shards, so it loads here. The
    # last, partial batch of the split is kept.
    from strajnet_tpu_torch.data.pipeline import as_numpy, make_eval_dataset

    return as_numpy(make_eval_dataset(file_pattern, batch_size,
                                      compact=compact, drop_remainder=False))


def evaluate_batches(model: nn.Module, eval_step: Callable,
                     batches: Iterable[Dict[str, np.ndarray]],
                     no_warp: bool = False) -> Dict[str, float]:
    """Runs ``eval_step`` over numpy batches and returns the means of the
    seven ``val_*`` metrics and the five ``val_*`` losses over the batches.

    The batches reach the model's device through
    :func:`~strajnet_tpu_torch.data.pipeline.prefetch_to_device`, so the
    copy of the next batch runs under the current step. Loss and metric
    sums stay device scalars; the one fetch to the host comes after the
    loop. An empty iterable gives an empty dict.
    """
    device = next(model.parameters()).device
    acc = MetricsAccumulator("val", no_warp=no_warp)
    losses_sum: Dict[str, torch.Tensor] = {}
    n = 0
    for tbatch in prefetch_to_device(batches, device):
        losses, metrics = eval_step(model, tbatch)
        acc.update_state(metrics)
        for k, v in losses.items():
            prev = losses_sum.get(k)
            losses_sum[k] = v if prev is None else prev + v
        n += 1
    if n == 0:
        return {}
    res = acc.get_result()
    sums = torch.stack(list(losses_sum.values())).tolist()
    res.update({f"val_{k}": v / n for k, v in zip(losses_sum, sums)})
    return res


def evaluate(file_pattern: str, weight_path: str = "", batch_size: int = 16,
             pallas: str = "auto", no_warp: bool = False,
             compact: bool = True, device="cuda",
             batches: Optional[Iterable[Dict[str, np.ndarray]]] = None
             ) -> Dict[str, float]:
    """Evaluates a checkpoint over the records matching ``file_pattern``, or
    over ``batches`` (dicts of numpy arrays with the parsed-TFRecord keys)
    when given; prints the metric block and one JSON line.

    The model is ``STRAJNET_CONFIG``; ``pallas`` takes the mode choices of
    the CLI.
    """
    cfg = STRAJNET_CONFIG
    if pallas != "auto":
        cfg = dataclasses.replace(cfg,
                                  use_pallas_attention=PALLAS_MODES[pallas])
    device = resolve_device(device)
    model = STrajNet(cfg)
    if weight_path:
        model.load_state_dict(load_weights(weight_path))
    else:
        model.load_state_dict(init_params(cfg,
                                          torch.Generator().manual_seed(0)))
    model = model.to(device).eval()
    eval_step = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(),
                               cfg.num_waypoints, no_warp=no_warp)
    if batches is None:
        batches = _tfrecord_batches(file_pattern, batch_size, compact)
    res = evaluate_batches(model, eval_step, batches, no_warp=no_warp)
    if not res:
        raise FileNotFoundError(
            f"no records matched {file_pattern!r}: --file_dir should be the "
            "preprocessed-data ROOT (the CLI appends /val/*.tfrecords)")
    print_metrics(res, "val", no_warp=no_warp)
    print(json.dumps(res))
    return res


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="STrajNet evaluation (PyTorch)")
    p.add_argument("--file_dir", type=str,
                   default="./Waymo_Dataset/preprocessed_data")
    p.add_argument("--weight_path", type=str, default="",
                   help="checkpoint directory of the training loop, or a .pt "
                        "state dict (tools/flax_to_torch.py converts a "
                        "checkpoint of the JAX package)")
    p.add_argument("--batch_size", type=int, default=16,
                   help="scenarios per device batch")
    p.add_argument("--pallas", type=str, default="auto",
                   choices=["auto"] + list(PALLAS_MODES),
                   help="Swin-block kernel mode (the train CLI's choices)")
    p.add_argument("--no_compact", action="store_true",
                   help="feed f32 from the host instead of uint8/f16")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model; 'cpu' only when asked")
    args = p.parse_args(argv)
    evaluate(f"{args.file_dir}/val/*.tfrecords", args.weight_path,
             args.batch_size, pallas=args.pallas,
             compact=not args.no_compact, device=args.device)


if __name__ == "__main__":
    main()
