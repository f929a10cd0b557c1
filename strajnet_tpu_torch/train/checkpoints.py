"""Checkpoints of the whole train state: parameters, Nadam state, step.

Counterpart of ``strajnet_tpu/train/checkpoints.py`` (there on Orbax). A
checkpoint is ``<directory>/<step>/state.pt``, a ``torch.save`` of
``{"model": state_dict, "optimizer": KerasNadam.state_dict(), "step": int}``
(the optimizer's state dict carries the moments, the update count and the
momentum-cache product; its schedule is code, not state). It is written
under a temporary name and renamed into place, so a save that is killed
leaves no checkpoint that :meth:`CheckpointManager.latest_step` would pick.
Beside it, ``meta_<step>.json`` holds what the caller passes as ``metrics``
(the training loop: ``epoch``, ``val_loss``, ``steps_per_epoch``), which
resume reads its epoch from. Reading uses ``weights_only=True``.

Under data parallelism (``parallel/ddp.py``) rank 0 writes, from the module
inside the DDP wrapper (no ``module.`` keys: a checkpoint of a DDP run loads
into one process and the other way round), and every rank waits at a
barrier until it has; every rank restores after a barrier.

Under a ``('data', 'model')`` mesh (``parallel/mesh.py``) a checkpoint still
holds whole parameters and whole moments: every rank gathers its
parameters' and moments' shards over ``'model'`` before rank 0 writes, and
a restore cuts the whole tensors to this rank's shards. So a checkpoint of
one process, of DDP and of any mesh restores into any of them.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from strajnet_tpu_torch.parallel import mesh as tp
from strajnet_tpu_torch.parallel.ddp import barrier, rank, unwrap

_STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 20):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"meta_{step}.json")

    def all_steps(self) -> List[int]:
        """The steps with a finished checkpoint, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, _STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, metrics: Optional[dict] = None):
        """Writes ``state`` (a ``TrainState``) as checkpoint ``step``;
        ``metrics`` (e.g. val_loss, epoch) also land in the JSON sidecar.
        Keeps the newest ``max_to_keep`` checkpoints. Under data parallelism
        rank 0 writes and every rank returns once it has; under a mesh every
        rank first gathers its shards (a collective over ``'model'``)."""
        payload = self._payload(state) if tp.tp_active() else None
        if rank() == 0:
            self._write(step, state, metrics, payload)
        barrier()

    @staticmethod
    def _payload(state: Any) -> Dict[str, Any]:
        """What a checkpoint holds, sharded tensors gathered whole."""
        return {"model": tp.whole_state_dict(unwrap(state.model)),
                "optimizer": tp.whole_optimizer_state(state.optimizer),
                "step": int(state.step)}

    def _write(self, step: int, state: Any, metrics: Optional[dict],
               payload: Optional[Dict[str, Any]] = None):
        if payload is None:
            payload = self._payload(state)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        final = self._step_dir(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if metrics:
            meta_tmp = tmp + ".json"
            with open(meta_tmp, "w") as f:
                json.dump(metrics, f)
            os.replace(meta_tmp, self._meta_path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
            if os.path.exists(self._meta_path(old)):
                os.remove(self._meta_path(old))

    def metadata(self, step: Optional[int] = None) -> dict:
        """Metrics sidecar saved alongside ``step`` (empty if absent)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return {}
        try:
            with open(self._meta_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _load(self, step: int) -> Dict[str, Any]:
        return torch.load(os.path.join(self._step_dir(step), _STATE_FILE),
                          map_location="cpu", weights_only=True)

    def restore_params(self, step: Optional[int] = None
                       ) -> Tuple[Optional[Dict[str, torch.Tensor]],
                                  Optional[int]]:
        """(the model's state dict, its step) of checkpoint ``step`` (default:
        the newest), on the CPU; ``(None, None)`` if there is none. Needs no
        optimizer, so inference can read any checkpoint of the loop."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        return self._load(step)["model"], step

    def restore(self, state: Any, step: Optional[int] = None):
        """Loads checkpoint ``step`` (default: the newest) into ``state``'s
        model, optimizer and step in place; returns ``(state, step)``, or
        ``(None, None)`` when there is no checkpoint. Under data parallelism
        every rank waits for the others first, then reads the same one;
        under a mesh it keeps its shards of the whole tensors."""
        barrier()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        payload = self._load(step)
        model = unwrap(state.model)
        model.load_state_dict(tp.local_state_dict(model, payload["model"]))
        state.optimizer.load_state_dict(tp.local_optimizer_state(
            state.optimizer, payload["optimizer"]))
        state.step = int(payload["step"])
        return state, step

    def close(self):
        """Nothing stays open between calls; kept for the JAX package's
        interface."""


def load_weights(weight_path: str) -> Dict[str, torch.Tensor]:
    """A model state dict, on the CPU, from a checkpoint directory of the
    training loop (its newest checkpoint, as the JAX CLIs read one) or from
    a ``.pt`` file. A directory without a checkpoint raises."""
    if os.path.isdir(weight_path):
        state_dict, step = CheckpointManager(weight_path).restore_params()
        if state_dict is None:
            raise FileNotFoundError(f"no checkpoint found under {weight_path}")
        print(f"loaded checkpoint at step {step}")
        return state_dict
    state_dict = torch.load(weight_path, map_location="cpu", weights_only=True)
    print(f"loaded weights from {weight_path}")
    return state_dict
