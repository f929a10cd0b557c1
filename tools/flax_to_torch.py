"""Convert an Orbax checkpoint of the JAX package to a PyTorch ``.pt`` file.

The inference CLI of the PyTorch port loads the result:

    python tools/flax_to_torch.py --checkpoint_dir ./ckpt --out weights.pt \
        [--step N]

    python -m strajnet_tpu_torch.infer.runner --weight_path weights.pt ...

Only the model parameters are read (``CheckpointManager.restore_params``),
so checkpoints of the training loop and of ``tools/import_ref_weights.py``
both convert. The layout mapping is ``strajnet_tpu_torch.interop.from_flax``.
"""

import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(checkpoint_dir: str, out: str, step: Optional[int] = None) -> int:
    """Writes the ``state_dict`` of ``checkpoint_dir``'s params to ``out``;
    returns the checkpoint step."""
    import jax
    import numpy as np
    import torch

    from strajnet_tpu.train.checkpoints import CheckpointManager
    from strajnet_tpu_torch.interop.from_flax import flax_to_state_dict

    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(f"no checkpoint directory {checkpoint_dir}")
    mngr = CheckpointManager(checkpoint_dir)
    try:
        params, step = mngr.restore_params(step)
    finally:
        mngr.close()
    if params is None:
        raise FileNotFoundError(f"no checkpoint found under {checkpoint_dir}")
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    torch.save(state, out)
    return step


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_dir", required=True,
                   help="Orbax checkpoint directory of the JAX package")
    p.add_argument("--out", required=True, help="output .pt file")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: the latest)")
    args = p.parse_args()

    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass
    step = convert(args.checkpoint_dir, args.out, args.step)
    print(f"converted step {step} of {args.checkpoint_dir} -> {args.out}")


if __name__ == "__main__":
    main()
