"""Import a published reference STrajNet ``.tf`` checkpoint as a ``.pt``.

    python -m strajnet_tpu_torch.tools.import_ref_weights \
        --weight_path /path/to/final_model.tf --out weights.pt \
        --ref_dir /path/to/reference [--variant paper|train_py]

    python -m strajnet_tpu_torch.infer.runner --weight_path weights.pt ...

Counterpart of the JAX package's ``tools/import_ref_weights.py``, in one hop:
the reference model is built from its sources (``--ref_dir``, the directory
that holds the reference's ``modules.py``) with TensorFlow and
``tf_keras``, the checkpoint is restored through Keras ``load_weights``, and
every weight is mapped onto ``STrajNet``'s keys
(``interop/ref_import.py``). The ``.pt`` holds the model's ``state_dict``,
which ``train/checkpoints.py::load_weights`` reads, so the serve and
evaluate CLIs take it as ``--weight_path``: the published model is served
without retraining.

It computes nothing on a device, and it needs TensorFlow: run it where
TensorFlow is installed (the card's machine has none) and copy the ``.pt``
over. ``--variant paper`` (default) expects a checkpoint trained with
``fg_msa=True, fg=True`` (``STRAJNET_CONFIG``); ``train_py`` the reference's
checked-in training variant without FG-MSA (``STRAJNET_TRAIN_PY_CONFIG``).
"""

from __future__ import annotations

import argparse
import os

import torch

from strajnet_tpu_torch.config import (STRAJNET_CONFIG,
                                       STRAJNET_TRAIN_PY_CONFIG)
from strajnet_tpu_torch.interop.ref_import import import_ref_checkpoint


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n")[0] + " Needs TensorFlow and "
        "tf_keras; runs on the CPU, not on the card's machine.")
    p.add_argument("--weight_path", required=True,
                   help="reference Keras checkpoint prefix (the '...model.tf'"
                        " path passed to the reference's load_weights)")
    p.add_argument("--out", required=True, help="output .pt file")
    p.add_argument("--ref_dir", required=True,
                   help="the reference's source checkout (the directory "
                        "that holds its modules.py)")
    p.add_argument("--variant", choices=("paper", "train_py"),
                   default="paper")
    args = p.parse_args(argv)
    cfg = (STRAJNET_CONFIG if args.variant == "paper"
           else STRAJNET_TRAIN_PY_CONFIG)
    state, cfg = import_ref_checkpoint(args.weight_path, model_cfg=cfg,
                                       ref_dir=args.ref_dir)
    torch.save(state, args.out)
    n = sum(v.numel() for v in state.values())
    print(f"imported {n:,} parameters from "
          f"{os.path.abspath(args.weight_path)} ({args.variant}) -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
