"""Training traffic: the program's training step at a fixed batch, one
client, steps dispatched ahead with one synchronise at the end of the
window.

Set-up builds one object, the train state (the program's ``STrajNet`` in
training mode with Keras Nadam on the SGDR schedule, as
``train/state.py::create_train_state`` makes it, with the benchmark's
weights), and the step of ``make_train_step(..., accumulate=True)``. It
drives that object through its first three steps, on three distinct batches
of the pool, through the window's own call; they warm every kernel up and
are what the reference checks. The window then drives the same object on.

Parameters (``benchmark/traffic/<name>.json``): ``batch``, ``pool`` (the
distinct batches cycled through), ``check_steps``, ``traced_steps``.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare, faults, pool as pools, weights
from benchmark.harness import Context
from benchmark.reference import loss as ref_loss
from benchmark.reference.prec import EXACT, Prec
from benchmark.trace import trace_steps

B1_SHARE = float(np.float32(1) - np.float32(0.9))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The program's train state, step and the cell's input pool."""

    def __init__(self, ctx: Context):
        from strajnet_tpu_torch.config import (LossConfig, TaskConfig,
                                               TrainConfig)
        from strajnet_tpu_torch.models.strajnet import STrajNet
        from strajnet_tpu_torch.train.state import TrainState, make_optimizer
        from strajnet_tpu_torch.train.step import (make_train_step,
                                                   zero_loss_sums)
        from benchmark.harness import ports_config

        dev, tr = ctx.device, ctx.traffic
        self.ctx, self.batch = ctx, tr["batch"]
        self.cfg = pools.with_sizes(ctx.model)
        ctx.mark("imported")
        self.pool = pools.make_pool(self.cfg, self.batch, tr["pool"],
                                    ctx.seed_of("data"), dev, train=True)
        ctx.mark("pool made")
        mcfg = ports_config(ctx.model)
        model = STrajNet(mcfg).to(dev).train()
        self.spec = weights.spec_of(model.state_dict())
        model.load_state_dict(faults.weights_seen(
            ctx.weights(self.spec), ctx.fault, ctx.reference.FAULT_LEAVES))
        self.state = TrainState(model, make_optimizer(TrainConfig(),
                                                      model.parameters()))
        task = TaskConfig(grid_height_cells=self.cfg["output_size"],
                          grid_width_cells=self.cfg["output_size"],
                          num_waypoints=mcfg.num_waypoints)
        self.step = make_train_step(task, LossConfig(), mcfg.num_waypoints,
                                    accumulate=True)
        self.zero = lambda: zero_loss_sums(dev)
        self.noise = torch.Generator(dev).manual_seed(ctx.seed_of("noise"))
        self.calls = 0
        plant(ctx.fault, self)
        ctx.mark("state built")

    def call(self, sums):
        """One step of the window's call on the pool's next batch."""
        batch = self.pool[self.calls % len(self.pool)]
        self.calls += 1
        self.state, sums = self.step(self.state, batch, self.noise, sums)
        return sums

    def check_steps(self, n: int) -> dict:
        """The first ``n`` steps, each from zero loss sums; the losses, the
        model's outputs in the first step (read by a forward hook, kept on
        the host), the first gradient read back from Nadam's first moment
        (per-leaf norms, and the tensors on the host), and each leaf's
        change over the ``n`` steps (float32 tensors on the host, the
        parameters' size)."""
        named = list(self.state.model.named_parameters())
        losses, grad, first = [], [], []
        hook = self.state.model.register_forward_hook(
            lambda _, __, out: first.append(out.detach().float().cpu()))
        for i in range(n):
            losses.append(self.call(self.zero())["total"])
            if i == 0:
                hook.remove()
                st = self.state.optimizer.state
                grad = [(st[p]["mu"] / B1_SHARE if p in st
                         else torch.zeros_like(p)).detach().float().cpu()
                        for _, p in named]
        p0 = self.ctx.weights(self.spec)
        names = [k for k, _ in named]
        return {"losses": [float(v) for v in losses], "out": first[0],
                "grad": {k: float(g.norm()) for k, g in zip(names, grad)},
                "grad_t": dict(zip(names, grad)),
                "delta": {k: (p.detach().float() - p0[k]).cpu()
                          for k, p in named}}


def plant(fault: Optional[str], prog: Program) -> None:
    """A fault under the timed path, for the checks' own tests: the step
    returns its state unchanged; half the batch is left out; one scene's
    outputs are altered where the model produces them (the weight faults
    of :mod:`benchmark.faults` are planted where the weights are
    loaded)."""
    if fault is None or fault in faults.WEIGHT_FAULTS:
        return
    step = prog.step
    if fault == "unchanged":
        def broken(state, batch, gen, sums):
            keep = copy.deepcopy(
                ({k: v.detach().clone() for k, v
                  in state.model.state_dict().items()},
                 state.optimizer.state_dict()))
            state, sums = step(state, batch, gen, sums)
            state.model.load_state_dict(keep[0])
            state.optimizer.load_state_dict(keep[1])
            return state, sums
    elif fault == "half":
        def broken(state, batch, gen, sums):
            return step(state, faults.halved(batch), gen, sums)
    elif fault == "altered":
        alter_outputs(prog.state.model)
        return
    else:
        raise ValueError(f"no fault {fault!r}")
    prog.step = broken


def alter_outputs(model: torch.nn.Module) -> None:
    """Shifts the first scene's outputs by one where the model returns
    them."""
    def hook(_, __, out):
        out = out.clone()
        out[0] += 1.0
        return out

    model.register_forward_hook(hook)


def reference_steps(ctx: Context, spec, pool: List[Dict[str, torch.Tensor]],
                    n: int, prec: Prec = EXACT,
                    fault: Optional[str] = None) -> dict:
    """The configuration's reference's first ``n`` steps from the same
    weights, batches and noise: what :meth:`Program.check_steps` reads.
    ``prec`` and a batch ``fault`` (:mod:`benchmark.faults`) put the control
    or a planted fault in the program's place."""
    dev = ctx.device
    t = ctx.model["num_waypoints"]
    with compare.exact_float32():
        p = ctx.weights(spec)
        names = list(p)
        params = [p[k].requires_grad_(True) for k in names]
        opt = ref_loss.Nadam(params)
        gen = torch.Generator(dev).manual_seed(ctx.seed_of("noise"))
        losses, grad = [], None
        for i in range(n):
            batch = pool[i % len(pool)]
            if fault == "half":
                batch = faults.halved(batch)
            out = ctx.reference.forward(p, ctx.model, batch, prec, gen)
            scored = batch
            if fault == "half_loss":
                scored = faults.halved(batch)
            total = ref_loss.total(ref_loss.loss_terms(
                scored, out[:scored["ogm"].shape[0]], t))
            grads = torch.autograd.grad(total, params, allow_unused=True)
            grads = [torch.zeros_like(q) if g is None else g
                     for q, g in zip(params, grads)]
            losses.append(float(total.detach()))
            if i == 0:
                grad = {k: g.detach() for k, g in zip(names, grads)}
                first = out.detach().cpu()
            opt.step(grads)
            del out, total, grads
        p0 = ctx.weights(spec)
        delta = {k: p[k].detach() - p0[k] for k in names}
    return {"losses": losses, "out": first,
            "grad": {k: float(g.norm()) for k, g in grad.items()},
            "grad_t": grad, "delta": delta}


def run(ctx: Context) -> dict:
    """Set-up, the window, the traced steps and the check, for one run."""
    tr = ctx.traffic
    prog = Program(ctx)
    got = prog.check_steps(tr["check_steps"])
    _sync(ctx.device)
    ctx.mark("check steps run")
    setup_s = time.perf_counter() - ctx.t0
    on_card = torch.device(ctx.device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    sums, steps = prog.zero(), 0
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        sums = prog.call(sums)
        steps += 1
    _sync(ctx.device)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    finite = bool(torch.isfinite(sums["total"]))
    trace = None
    if ctx.trace:
        box = {"sums": prog.zero()}

        def traced(_):
            box["sums"] = prog.call(box["sums"])

        trace = trace_steps(traced, tr["traced_steps"],
                            lambda: _sync(ctx.device))
    spec, pool = prog.spec, prog.pool
    del prog, sums
    if on_card:
        torch.cuda.empty_cache()
    ref = reference_steps(ctx, spec, pool, tr["check_steps"])
    readings = compare.training_gaps(got, ref)
    return dict(setup_s=setup_s, window_s=window_s, steps=steps,
                peak=peak, spec=spec,
                held=pools.nbytes(pool), attempted=steps,
                failed=0 if finite else steps, readings=readings,
                trace=trace,
                e2e={"train_scenes_per_s": steps * tr["batch"] / window_s})


def calibrate(ctx: Context, precs) -> dict:
    """The limits' readings for one seed, each against the exact reference:
    the program's check steps; the program with a fault planted (its state
    left unchanged, one scene's outputs altered, and the weight faults);
    the reference in each control's precision and with each batch fault
    (:mod:`benchmark.faults`)."""
    tr = ctx.traffic
    got = {}
    for fault in (None, "unchanged", "altered") + faults.WEIGHT_FAULTS:
        prog = Program(dataclasses.replace(ctx, fault=fault))
        got[fault or "program"] = prog.check_steps(tr["check_steps"])
        spec, pool = prog.spec, prog.pool
        del prog
        if torch.device(ctx.device).type == "cuda":
            torch.cuda.empty_cache()
    ref = reference_steps(ctx, spec, pool, tr["check_steps"])
    for p in precs:
        got[p.name] = reference_steps(ctx, spec, pool, tr["check_steps"], p)
    for fault in faults.BATCH_FAULTS:
        got[fault] = reference_steps(ctx, spec, pool, tr["check_steps"],
                                     fault=fault)
    return {k: compare.training_gaps(v, ref) for k, v in got.items()}
