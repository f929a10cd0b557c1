"""Flax parameter trees (of numpy arrays) -> the port's ``state_dict``, and
the JAX package's Nadam state -> ``KerasNadam.state_dict()``.

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

The optimizer's moments ``mu`` and ``nu`` are trees of the parameters' shape
and convert leaf by leaf with the same mapping; the step count and the
momentum-cache product are scalars.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

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


def find_nadam_state(opt_state: Any) -> Optional[Mapping]:
    """The ``KerasNadamState`` inside an optax state, as a mapping with the
    keys ``count``, ``mu``, ``nu`` and ``mu_product``. Walks tuples, lists,
    named tuples and mappings (a checkpoint read back without a template
    holds mappings), so chained transforms (gradient clipping, the
    learning-rate scale) may wrap it."""
    fields = ("count", "mu", "nu", "mu_product")
    if isinstance(opt_state, Mapping):
        if all(k in opt_state for k in fields):
            return {k: opt_state[k] for k in fields}
        children = list(opt_state.values())
    elif all(hasattr(opt_state, k) for k in fields):
        return {k: getattr(opt_state, k) for k in fields}
    elif isinstance(opt_state, (tuple, list)):
        children = list(opt_state)
    else:
        return None
    for child in children:
        found = find_nadam_state(child)
        if found is not None:
            return found
    return None


def nadam_state_to_state_dict(model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer,
                              nadam_state: Mapping) -> dict:
    """A ``state_dict`` for ``optimizer`` (a ``KerasNadam`` over
    ``model.parameters()``, in that order) that holds the JAX package's
    optimizer state: ``load_state_dict`` of it continues the JAX run.

    ``nadam_state`` has ``count``, ``mu_product`` (scalars) and ``mu``,
    ``nu`` (Flax trees of numpy arrays shaped like the parameters). The
    learning-rate schedule's own count equals ``count`` and is not stored
    apart.
    """
    mu = flax_to_state_dict(nadam_state["mu"])
    nu = flax_to_state_dict(nadam_state["nu"])
    names = [name for name, _ in model.named_parameters()]
    missing = [n for n in names if n not in mu or n not in nu]
    if missing or len(mu) != len(names):
        raise ValueError(f"optimizer state and model disagree: missing "
                         f"{missing[:5]}, {len(mu)} leaves for {len(names)} "
                         f"parameters")
    out = optimizer.state_dict()
    if sum(len(g["params"]) for g in out["param_groups"]) != len(names):
        raise ValueError("the optimizer does not hold the model's parameters")
    out["state"] = {i: {"mu": mu[n], "nu": nu[n]}
                    for i, n in enumerate(names)}
    for group in out["param_groups"]:
        group["count"] = int(np.asarray(nadam_state["count"]))
        group["mu_product"] = float(np.asarray(nadam_state["mu_product"]))
    return out
