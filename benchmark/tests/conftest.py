"""Shared fixtures of the benchmark's own tests: a TINY configuration of
the model (the widths of the package's ``TINY_MODEL_CONFIG``) as the
configuration files state theirs, and a CPU run context."""

import dataclasses
import time

import pytest
import torch

from benchmark import harness

TINY = dict(input_size=[64, 64], window_size=4, embed_dim=16,
            depths=[2, 2, 2], num_heads=[1, 2, 4], traj_out_dim=64,
            traj_heads=2, att_heads=2, obs_actors=6, occ_actors=2,
            map_segments=8, fgmsa_heads=8, fgmsa_head_channels=8,
            fgmsa_groups=8)


def tiny_model(name: str = "strajnet_fgmsa_bf16", **changes) -> dict:
    """A configuration file's model settings with TINY's widths."""
    spec = harness.load_spec()
    model = harness.find_config(spec, name)["model"]
    return dict(model, **TINY, **changes)


def tiny_context(model: dict, traffic: dict, limits=None, seed=2 ** 31 + 7,
                 seconds=0.3, trace=False, fault=None) -> harness.Context:
    return harness.Context(
        cell={"name": "tiny", "chips": 1}, model=model,
        reference=harness.load_reference({}), traffic=traffic,
        limits=limits or {}, seed=seed, seconds=seconds, trace=trace,
        device=torch.device("cpu"), t0=time.perf_counter(), fault=fault)


TRAIN = {"kind": "train", "batch": 4, "pool": 4, "check_steps": 3,
         "traced_steps": 2}
INFER = {"kind": "infer", "batch": 4, "pool": 4, "sample": 2, "ref_rows": 2,
         "traced_steps": 2}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
    yield


def port_config(model: dict):
    from strajnet_tpu_torch.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in model.items() if k in fields})
