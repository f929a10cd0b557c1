"""Flax parameter trees (of numpy arrays) -> the port's ``state_dict``.

The port's modules carry the Flax module names, so each leaf maps by path:
``a/b/c`` becomes ``a.b.c`` with these layout changes:

- ``LayerNorm_0`` wrappers disappear and ``scale`` becomes ``weight``;
- Dense ``kernel [in, out]`` -> ``weight [out, in]``;
- Conv ``kernel`` HWIO -> OIHW ``weight``, grouped convs included (Flax's
  ``[kh, kw, in/groups, out]`` is PyTorch's ``[out, in/groups, kh, kw]``);
- the 1-wide Conv1D ``node_feature`` ``kernel [1, in, out]`` -> Linear
  ``weight [out, in]``;
- ``TemporalConv`` ``kernel [kt, C, F]``, the MHA kernels ``[h, in, d]`` /
  ``[h, d, out]`` and the rel-pos tables keep their layout;
- ``nn.vmap``-stacked subtrees (``cross_attn_obs``: one leading waypoint
  axis on every leaf) split into ``cross_attn_obs.<t>.`` entries.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_STACKED = ("cross_attn_obs",)


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def convert_leaf(path: Tuple[str, ...], arr: np.ndarray
                 ) -> Tuple[str, np.ndarray]:
    """One unstacked Flax leaf -> (torch key, array in torch layout)."""
    parts = [p for p in path if p != "LayerNorm_0"]
    mod, name = parts[:-1], parts[-1]
    if name == "scale":
        name = "weight"
    elif name == "kernel":
        if arr.ndim == 2:                          # Dense [in, out]
            name, arr = "weight", arr.T
        elif arr.ndim == 4:                        # Conv HWIO
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3 and mod and mod[-1] == "node_feature":
            name, arr = "weight", arr[0].T         # Conv1D, width 1
        elif arr.ndim != 3:                        # TemporalConv keeps [kt,C,F]
            raise ValueError(f"unexpected kernel {'/'.join(path)} "
                             f"{arr.shape}")
    return ".".join(mod + [name]), arr


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Converts a Flax param tree (``{"params": ...}`` or the inner tree) of
    a model or any of its submodules into a ``state_dict`` of f32 tensors."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, arr: np.ndarray) -> None:
        if key in out:
            raise ValueError(f"two Flax leaves map to {key}")
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    for path, arr in _flatten(params):
        stacked = [i for i, p in enumerate(path[:-1]) if p in _STACKED]
        if stacked:
            i = stacked[0]
            for t in range(arr.shape[0]):
                sub = path[:i + 1] + (str(t),) + path[i + 1:]
                put(*convert_leaf(sub, arr[t]))
        else:
            put(*convert_leaf(path, arr))
    return out
