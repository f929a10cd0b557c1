"""Convert an Orbax checkpoint of the JAX package to a PyTorch ``.pt`` file.

The inference CLI of the PyTorch port loads the result:

    python tools/flax_to_torch.py --checkpoint_dir ./ckpt --out weights.pt \
        [--step N] [--optimizer_out nadam.pt]

    python -m strajnet_tpu_torch.infer.runner --weight_path weights.pt ...

The model parameters are read without a state template, so checkpoints of
the training loop and of ``tools/import_ref_weights.py`` both convert. With
``--optimizer_out`` the Nadam state of a training checkpoint (step count,
both moments, the momentum-cache product) is written as well, as a
``KerasNadam.state_dict()`` that ``optimizer.load_state_dict`` takes, so that
training continues where the JAX run stopped. The layout mapping is
``strajnet_tpu_torch.interop.from_flax``.
"""

import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(checkpoint_dir: str, out: str, step: Optional[int] = None,
            optimizer_out: Optional[str] = None) -> int:
    """Writes the ``state_dict`` of ``checkpoint_dir``'s params to ``out``
    and, if asked, its Nadam state to ``optimizer_out``; returns the
    checkpoint step."""
    import jax
    import numpy as np
    import torch

    from strajnet_tpu.train.checkpoints import CheckpointManager
    from strajnet_tpu_torch.interop.from_flax import (
        find_nadam_state, flax_to_state_dict, nadam_state_to_state_dict)

    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(f"no checkpoint directory {checkpoint_dir}")
    mngr = CheckpointManager(checkpoint_dir)
    try:
        params, step = mngr.restore_params(step)
        raw = mngr._mngr.restore(step) if optimizer_out else None
    finally:
        mngr.close()
    if params is None:
        raise FileNotFoundError(f"no checkpoint found under {checkpoint_dir}")
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    torch.save(state, out)
    if optimizer_out:
        from strajnet_tpu_torch.config import STRAJNET_CONFIG, TrainConfig
        from strajnet_tpu_torch.models.strajnet import STrajNet
        from strajnet_tpu_torch.train.state import make_optimizer

        opt_state = (raw.get("opt_state") if isinstance(raw, dict)
                     else getattr(raw, "opt_state", None))
        nadam = find_nadam_state(jax.tree_util.tree_map(np.asarray,
                                                        opt_state))
        if nadam is None:
            raise ValueError(f"step {step} of {checkpoint_dir} holds no "
                             f"Nadam state")
        model = STrajNet(STRAJNET_CONFIG)
        optimizer = make_optimizer(TrainConfig(), model.parameters())
        torch.save(nadam_state_to_state_dict(model, optimizer, nadam),
                   optimizer_out)
    return step


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_dir", required=True,
                   help="Orbax checkpoint directory of the JAX package")
    p.add_argument("--out", required=True, help="output .pt file")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: the latest)")
    p.add_argument("--optimizer_out", default=None,
                   help="also write the Nadam state as a "
                        "KerasNadam.state_dict() to this .pt file")
    args = p.parse_args()

    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass
    step = convert(args.checkpoint_dir, args.out, args.step,
                   args.optimizer_out)
    print(f"converted step {step} of {args.checkpoint_dir} -> {args.out}")


if __name__ == "__main__":
    main()
