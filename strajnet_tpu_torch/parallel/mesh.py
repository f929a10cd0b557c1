"""Tensor parallelism: the ``('data', 'model')`` mesh of the JAX package.

Counterpart of ``strajnet_tpu/parallel/mesh.py``. The JAX package runs one
program over a ``Mesh(('data', 'model'))``: the batch is sharded over
``'data'``, the large Dense and MHA kernels over ``'model'`` by the name
rules :data:`_PARAM_RULES`, and GSPMD inserts the collectives. Here each
rank is a process; rank ``r`` of ``world`` sits at ``(r // model_axis,
r % model_axis)`` of a :class:`~torch.distributed.device_mesh.DeviceMesh`,
holds the rows of its ``'data'`` coordinate (peers along ``'model'`` hold the
same rows) and the shards of its ``'model'`` coordinate.

Parameters are plain local shards, not DTensors: a sharded ``nn.Parameter``
holds its slice and carries ``tp_dim``, the dimension it is split on
(:func:`shard_params`), and the layers call the collectives of this module
on the ``'model'`` group themselves. The CUDA kernels take raw pointers
through ctypes and their ``autograd.Function`` s see plain tensors, so the
mesh boundary has to sit around the call anyway, as ``shard_map`` does in
JAX; with plain shards the boundary is one all-gather per weight
(:func:`whole`), whose backward keeps this rank's slice of the gradient.
The gradient of every parameter, sharded or not, is then summed over
``'data'`` only, by the DDP wrapper over the ``'data'`` group
(``parallel/ddp.py``): peers along ``'model'`` compute the same rows, so a
sum over ``'model'`` would count each row ``model_axis`` times. Their
gradients of a replicated parameter agree only up to rounding, though (the
kernels' weight gradients flush column sums with float atomics, cuDNN's are
not deterministic), and Nadam would let the copies drift apart; so the step
gives every replicated gradient model-rank 0's value before the update
(:func:`align_replicated_grads`), and the copies stay bit-equal.

What each layer does under a ``'model'`` axis:

- computed on the shards: the Swin MLP in the plain mode (fc1
  column-parallel, fc2 row-parallel, one all-reduce) and the Swin ``proj``
  in the plain mode (row-parallel on this rank's columns of the attention
  output); a TF-Addons MHA whose heads divide the axis (each rank its heads,
  the output projection summed); the FFN pair of a cross-attention block
  (FFN1 column-, FFN2 row-parallel);
- gathered whole: ``qkv`` (its 3C columns interleave q, k and v, so a
  contiguous shard holds no whole heads, and GSPMD would reshard it so), and
  every weight of a kernel call (K1/K2, K3/K4, K7 and K5 run inside
  :func:`data_shard_map` on this rank's rows);
- ``spatial_shard``'s hints (:func:`sharding_hint`) pin the layout JAX
  would give an activation (split over ``'model'``, the next consumer
  gathering it again, as at JAX's ``shard_map`` boundaries) only as a
  record of its shard shapes: nothing computes on a split activation yet,
  so the activation stays whole and no bytes move.

A layer whose input is replicated over ``'model'`` and which computes on
shards takes it through :func:`copy_to_model` (identity forward, all-reduce
of the gradient) and gives its output through :func:`reduce_from_model`
(all-reduce forward, identity backward), so that every activation between
layers, and its gradient, is whole and alike on the peers along ``'model'``.

Without an active mesh (:func:`use_mesh`) every helper here returns its
input, so one process and pure data parallelism run as before.
"""

from __future__ import annotations

import contextlib
import re
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

DATA, MODEL = "data", "model"

# (regex on the port's state-dict key, whether the JAX leaf is stacked per
# waypoint, spec in the torch layout) - first match wins, as in JAX. The JAX
# rules are on Flax paths and layouts; ``interop/from_flax.py`` maps them:
# a Dense kernel [in, out] is a Linear weight [out, in], so P(None, 'model')
# becomes a split of dim 0 and P('model', None) of dim 1; the MHA kernels
# [h, in, d] / [h, d, out] keep their layout; the ``nn.vmap``-stacked leaves
# of ``cross_attn_obs`` and ``map_cross_attn`` carry a leading waypoint axis
# in Flax and are one ``<name>.<t>.`` entry per waypoint here, so JAX's head
# axis at index 1 is index 0 of each entry, and a rule written for an
# unstacked leaf does not take them (JAX's rank check skips it).
_PARAM_RULES: Tuple[Tuple[str, bool, Tuple[Optional[str], ...]], ...] = (
    # Swin window attention: qkv column-parallel, proj row-parallel.
    (r"attn\.qkv\.weight$", False, (MODEL, None)),
    (r"attn\.proj\.weight$", False, (None, MODEL)),
    # MLPs: fc1 column-parallel, fc2 row-parallel.
    (r"mlp\.fc1\.weight$", False, (MODEL, None)),
    (r"mlp\.fc2\.weight$", False, (None, MODEL)),
    # tfa-style MHA: shard the head axis.
    (r"(query|key|value)_kernel$", False, (MODEL, None, None)),
    (r"projection_kernel$", False, (MODEL, None, None)),
    # per-waypoint cross-attention: the head axis of each waypoint's block
    (r"cross_attn_obs\.\d+\..*(query|key|value)_kernel$", True,
     (MODEL, None, None)),
    (r"cross_attn_obs\.\d+\..*projection_kernel$", True,
     (MODEL, None, None)),
    # Trajectory FFNs.
    (r"FFN1\.weight$", False, (MODEL, None)),
    (r"FFN2\.weight$", False, (None, MODEL)),
)
_STACKED = re.compile(r"(^|\.)(cross_attn_obs|map_cross_attn)\.\d+\.")

_mesh: Optional[DeviceMesh] = None
# bytes of the collectives' results on this rank, by mesh axis
collective_bytes: Dict[str, int] = {DATA: 0, MODEL: 0}
_hint_log: Optional[List[Tuple[Tuple, Tuple[int, ...], Tuple[int, ...]]]] = \
    None


def create_mesh(model_axis: int = 1,
                device: Any = "cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh over the process group's ranks: rank
    ``r`` at ``(r // model_axis, r % model_axis)``. The world size must be
    divisible by ``model_axis``; a missing process group raises. The
    ``DeviceMesh`` sets no device of its own once the process has touched
    the card (``parallel/ddp.py::init_distributed`` sets it first), so
    several ranks may share one card over ``gloo``."""
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_axis={model_axis}")
    if not grouped:
        raise ValueError("create_mesh needs a process group "
                         "(parallel/ddp.py::init_distributed)")
    grid = torch.arange(n).reshape(n // model_axis, model_axis)
    return DeviceMesh(torch.device(device).type, grid,
                      mesh_dim_names=(DATA, MODEL))


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]) -> Iterator[Optional[DeviceMesh]]:
    """Makes ``mesh`` the active mesh inside the block (JAX's ``with
    mesh:``); the layers and rank helpers read it from there."""
    global _mesh
    prev, _mesh = _mesh, mesh
    try:
        yield mesh
    finally:
        _mesh = prev


def active_mesh() -> Optional[DeviceMesh]:
    """The active mesh, when it has more than one rank; else None."""
    m = _mesh
    return None if m is None or m.size() <= 1 else m


def axis_size(axis: str) -> int:
    """The size of ``axis`` of the active mesh; 1 without one."""
    m = _mesh
    return 1 if m is None else m.size(m.mesh_dim_names.index(axis))


def axis_rank(axis: str) -> int:
    """This rank's coordinate along ``axis``; 0 without a mesh."""
    m = _mesh
    return 0 if m is None else m.get_local_rank(axis)


def axis_group(axis: str) -> dist.ProcessGroup:
    """The process group of this rank's peers along ``axis``."""
    return _mesh.get_group(axis)


def param_partition_spec(key: str, shape: Sequence[int], model_size: int):
    """``Shard(dim)`` or ``Replicate()`` for the parameter ``key`` (a key of
    the port's ``state_dict``) of ``shape`` on a ``'model'`` axis of
    ``model_size``: JAX's rules, first match wins. A rule only applies if
    its rank matches and the sharded dimension divides by ``model_size``
    (3-head attention stays replicated on a ``model_axis=2`` mesh)."""
    stacked = bool(_STACKED.search(key))
    for pattern, rule_stacked, spec in _PARAM_RULES:
        if not re.search(pattern, key):
            continue
        if rule_stacked != stacked or len(spec) != len(shape):
            continue
        dim = spec.index(MODEL)
        if shape[dim] % model_size != 0:
            continue
        return Shard(dim) if model_size > 1 else Replicate()
    return Replicate()


def placement(p: torch.Tensor) -> Optional[int]:
    """The dimension a parameter is split on over ``'model'``, or None."""
    return getattr(p, "tp_dim", None)


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Cuts every parameter of ``model`` (unwrapped, whole, alike on every
    rank) to this rank's shard by :func:`param_partition_spec`, in place,
    and marks it with ``tp_dim``; the rest stay whole (replicated)."""
    size = mesh.size(mesh.mesh_dim_names.index(MODEL))
    me = mesh.get_local_rank(MODEL)
    for key, p in model.named_parameters():
        spec = param_partition_spec(key, p.shape, size)
        if isinstance(spec, Shard):
            p.data = p.data.chunk(size, spec.dim)[me].clone()
            p.tp_dim = spec.dim
    return model


def shard_batch(batch: Dict[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays or tensors): the
    rows of its ``'data'`` coordinate; peers along ``'model'`` get the same
    rows. A batch the data axis does not divide raises."""
    size = mesh.size(mesh.mesh_dim_names.index(DATA))
    me = mesh.get_local_rank(DATA)
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % size != 0:
            raise ValueError(f"{k}: global batch {n} not divisible by the "
                             f"data axis of {size}")
        rows = n // size
        out[k] = v[me * rows:(me + 1) * rows]
    return out


# --- collectives on one axis of the active mesh --------------------------


def all_gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``."""
    n = axis_size(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=axis_group(axis))
    out = torch.cat(parts, dim=dim)
    collective_bytes[axis] += out.numel() * out.element_size()
    return out


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, in f32, in ``x``'s dtype; ``x`` is
    not changed."""
    y = x.float().clone() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(y, group=axis_group(axis))
    collective_bytes[axis] += y.numel() * y.element_size()
    return y.to(x.dtype)


class _GatherWhole(torch.autograd.Function):
    """A parameter's shards gathered over ``'model'``; the backward keeps
    this rank's slice of the gradient (the peers' gradients of the whole
    weight are alike: they computed the same rows)."""

    @staticmethod
    def forward(ctx, p, dim):
        ctx.dim = dim
        return all_gather(p.detach(), dim, MODEL)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(axis_size(MODEL), ctx.dim)[axis_rank(MODEL)]
                .contiguous(), None)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, MODEL)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce(x, MODEL)

    @staticmethod
    def backward(ctx, g):
        return g


def tp_active() -> bool:
    """True under an active mesh whose ``'model'`` axis has several ranks."""
    return _mesh is not None and axis_size(MODEL) > 1


def split_on(p: torch.Tensor, dim: int) -> bool:
    """Whether ``p`` is split on ``dim`` over ``'model'``; a split
    parameter used outside its mesh raises."""
    d = placement(p)
    if d is None:
        return False
    if not tp_active():
        raise RuntimeError("a parameter sharded over 'model' used outside "
                           "its mesh (parallel/mesh.py::use_mesh)")
    return d == dim


def whole(p: torch.Tensor) -> torch.Tensor:
    """``p`` gathered whole over ``'model'`` where it is a sharded
    parameter; else ``p`` itself."""
    dim = placement(p)
    if dim is None:
        return p
    split_on(p, dim)
    return _GatherWhole.apply(p, dim)


def align_replicated_grads(model: nn.Module) -> None:
    """Gives the gradient of every parameter not split over ``'model'`` the
    value of model-rank 0's, in one broadcast of the flattened gradients
    over ``'model'``: the peers compute them from the same rows, but only
    alike up to rounding. Nothing without a ``'model'`` axis."""
    if not tp_active():
        return
    grads = [p.grad for p in model.parameters()
             if placement(p) is None and p.grad is not None]
    if not grads:
        return
    group = axis_group(MODEL)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    collective_bytes[MODEL] += flat.numel() * flat.element_size()
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; the gradient is summed over ``'model'`` (the input of a
    layer computed on shards)."""
    return _CopyToModel.apply(x) if tp_active() else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``'model'`` of the ranks' partial results; the gradient
    passes as it is (the output of a row-parallel layer)."""
    return _ReduceFromModel.apply(x) if tp_active() else x


def local_part(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of a tensor alike on the peers along
    ``'model'`` (e.g. a replicated bias of a column-parallel layer, taken
    through :func:`copy_to_model` first so its gradient is whole)."""
    if not tp_active():
        return t
    return t.chunk(axis_size(MODEL), dim)[axis_rank(MODEL)]


def model_split(dim: int) -> Optional[Tuple[int, int, int]]:
    """``(dim, this rank's part, parts)`` of a tensor split on ``dim`` over
    ``'model'`` (for ``ops/dropout.py``), or None without the axis."""
    if not tp_active():
        return None
    return dim, axis_rank(MODEL), axis_size(MODEL)


def sharding_hint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``spatial_shard``'s layout hint. Returns ``x`` itself: no layer here
    computes on an activation split over ``'model'`` yet (a convolution on
    H shards needs a halo exchange), and a split that the next consumer
    gathers straight back would only move bytes. Under an active mesh with a
    ``'model'`` axis whose size divides ``x``'s dimension named ``'model'``
    in ``axes``, it records ``(axes, local shape, whole shape)`` of the
    split JAX's ``with_sharding_constraint`` would lay out
    (:func:`record_hints`); elsewhere nothing, as JAX returns ``x`` without
    a mesh. ``'data'`` names the rows, which are this rank's already."""
    if not tp_active() or MODEL not in axes or _hint_log is None:
        return x
    dim = axes.index(MODEL)
    if dim < x.dim() and x.shape[dim] % axis_size(MODEL) == 0:
        local = list(x.shape)
        local[dim] //= axis_size(MODEL)
        _hint_log.append((tuple(axes), tuple(local), tuple(x.shape)))
    return x


@contextlib.contextmanager
def record_hints() -> Iterator[List]:
    """Collects ``(axes, local shape, whole shape)`` of every activation
    :func:`sharding_hint` would lay out split, inside the block."""
    global _hint_log
    prev, _hint_log = _hint_log, []
    try:
        yield _hint_log
    finally:
        _hint_log = prev


def check_rows(rows: int) -> None:
    """Raises unless every rank along ``'data'`` holds ``rows`` rows, i.e.
    unless the global rows divide the axis (JAX's ``shard_map`` needs
    that); one all-gather of a count over ``'data'``, made once per step by
    ``train/step.py`` before the forward, so that no kernel inside
    :func:`data_shard_map` (K5 among them) runs on uneven rows. Nothing on
    a data axis of one."""
    axis, n = DATA, axis_size(DATA)
    if n == 1:
        return
    group = axis_group(axis)
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    mine = torch.tensor([rows], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(counts, mine, group=group)
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise ValueError(f"the {axis!r} axis of {n} ranks holds {counts} "
                         f"rows: {sum(counts)} rows do not divide it evenly "
                         f"(a shard_map over {axis!r} needs equal rows)")


def data_shard_map(fn: Callable, mesh: Optional[DeviceMesh], n_sharded: int,
                   n_replicated: int) -> Callable:
    """``fn(*sharded, *replicated)`` on this rank's rows, the counterpart of
    JAX's ``data_shard_map``. The first ``n_sharded`` arguments are this
    rank's rows (that the ranks along ``'data'`` hold alike many is checked
    once per step, :func:`check_rows`); of the other ``n_replicated``, a
    parameter sharded over ``'model'`` arrives gathered whole
    (:func:`whole`: its gradient is this rank's slice, summed over
    ``'data'`` with every other gradient by the DDP wrapper). Without a
    mesh, ``fn`` itself."""
    if mesh is None:
        return fn

    def wrapped(*args):
        if len(args) != n_sharded + n_replicated:
            raise TypeError(f"{len(args)} arguments, expected "
                            f"{n_sharded} + {n_replicated}")
        rows = {a.shape[0] for a in args[:n_sharded]}
        if len(rows) != 1:
            raise ValueError(f"sharded arguments with rows {sorted(rows)}")
        return fn(*args[:n_sharded],
                  *(whole(a) for a in args[n_sharded:]))

    return wrapped


# --- whole checkpoints -----------------------------------------------------


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with each sharded parameter gathered whole
    over ``'model'`` (a collective: every rank of the axis calls it)."""
    sd = model.state_dict()
    for key, p in model.named_parameters():
        dim = placement(p)
        if dim is not None:
            sd[key] = all_gather(p.detach(), dim, MODEL)
    return sd


def local_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to this rank's shards of ``model``."""
    out = dict(sd)
    for key, p in model.named_parameters():
        dim = placement(p)
        if dim is not None and key in out:
            out[key] = local_part(out[key], dim).clone()
    return out


def _optimizer_params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def whole_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with the per-parameter state of sharded
    parameters (Nadam's ``mu`` and ``nu``) gathered whole over
    ``'model'``."""
    sd = optimizer.state_dict()
    params = _optimizer_params(optimizer)
    state = {}
    for i, s in sd["state"].items():
        dim = placement(params[i])
        state[i] = ({k: (all_gather(v, dim, MODEL)
                         if isinstance(v, torch.Tensor) and v.dim() else v)
                     for k, v in s.items()} if dim is not None else s)
    return dict(sd, state=state)


def local_optimizer_state(optimizer: torch.optim.Optimizer, sd: dict) -> dict:
    """A whole optimizer state dict cut to this rank's shards."""
    params = _optimizer_params(optimizer)
    state = {}
    for i, s in sd["state"].items():
        dim = placement(params[int(i)])
        state[i] = ({k: (local_part(v, dim).clone()
                         if isinstance(v, torch.Tensor) and v.dim() else v)
                     for k, v in s.items()} if dim is not None else s)
    return dict(sd, state=state)

