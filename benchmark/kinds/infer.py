"""Serving traffic: the program's predict step at a fixed batch, one client,
a synchronise after every batch (closed loop).

Set-up builds the program's ``STrajNet`` in ``eval()`` with the benchmark's
weights and ``make_predict_step``'s step, and warms it up on each batch of
the pool. Each batch of the window is timed on the host clock from the
call to its outputs being complete on the card. A sample of the window's
batches, drawn from the seed as the window runs (a reservoir), keeps its
outputs; once the window has closed, the reference recomputes those batches
and every scene of them is compared.

Parameters (``benchmark/traffic/<name>.json``): ``batch``, ``pool``,
``sample`` (batches kept for the check), ``ref_rows`` (scenes per reference
pass), ``traced_steps``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import List

import numpy as np
import torch

from benchmark import compare, faults, pool as pools, weights
from benchmark.harness import Context, judge
from benchmark.kinds.train import _sync, alter_outputs
from benchmark.reference.prec import EXACT, Prec
from benchmark.trace import trace_steps


class Program:
    """The program's model in ``eval()``, its predict step and the pool."""

    def __init__(self, ctx: Context):
        from strajnet_tpu_torch.models.strajnet import STrajNet
        from strajnet_tpu_torch.train.step import make_predict_step
        from benchmark.harness import ports_config

        dev, tr = ctx.device, ctx.traffic
        self.ctx, self.batch = ctx, tr["batch"]
        self.cfg = pools.with_sizes(ctx.model)
        ctx.mark("imported")
        self.pool = pools.make_pool(self.cfg, self.batch, tr["pool"],
                                    ctx.seed_of("data"), dev, train=False)
        ctx.mark("pool made")
        mcfg = ports_config(ctx.model)
        self.model = STrajNet(mcfg).to(dev).eval()
        self.spec = weights.spec_of(self.model.state_dict())
        self.model.load_state_dict(faults.weights_seen(
            ctx.weights(self.spec), ctx.fault, ctx.reference.FAULT_LEAVES))
        self.step = make_predict_step(mcfg.num_waypoints)
        ctx.mark("model built")
        if ctx.fault == "half":
            step = self.step

            def broken(model, batch):
                return step(model, faults.halved(batch))

            self.step = broken
        elif ctx.fault == "altered":
            alter_outputs(self.model)
        elif ctx.fault not in (None,) + faults.WEIGHT_FAULTS:
            raise ValueError(f"no fault {ctx.fault!r}")

    def call(self, i: int):
        """The batch ``i`` of the window: (observed, occluded, flow)."""
        out = self.step(self.model, self.pool[i % len(self.pool)])
        return (out.observed_occupancy, out.occluded_occupancy, out.flow)


def held_bytes(tensors) -> int:
    """Device bytes that keeping ``tensors`` holds: their storages, each
    once (a view holds the whole of its base's)."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def reference(ctx: Context, spec, batch, rows: int, prec: Prec = EXACT):
    """The configuration's reference's (observed, occluded, flow) of a
    batch, ``rows`` scenes at a time, each ``[scenes, T, H, W, c]``:
    occupancy logits and the flow."""
    t = ctx.model["num_waypoints"]
    parts = []
    with torch.no_grad(), compare.exact_float32():
        p = ctx.weights(spec)
        n = batch["ogm"].shape[0]
        for lo in range(0, n, rows):
            chunk = {k: v[lo:lo + rows] for k, v in batch.items()}
            y = ctx.reference.forward(p, ctx.model, chunk, prec)
            b, h, w, _ = y.shape
            y = y.reshape(b, h, w, t, 4).permute(0, 3, 1, 2, 4)
            parts.append((y[..., 0:1].clone(), y[..., 1:2].clone(),
                          y[..., 2:4].clone()))
    return tuple(torch.cat([q[i] for q in parts]) for i in range(3))


def gaps(got, ref) -> dict:
    """``out_gap`` (``compare.scene_gap``) of the occupancy logits, read back
    from the predict step's probabilities, and the flow. ``got``: the
    predict step's (probabilities, probabilities, flow); ``ref``: the
    reference's (logits, logits, flow)."""
    logits = [torch.logit(g.double(), eps=1e-12).float() for g in got[:2]]
    return {"out_gap": compare.scene_gap(logits + [got[2]], list(ref))}


def worst_of(batches) -> dict:
    """Each number's worst over the compared batches."""
    return {k: compare.worst([b[k] for b in batches]) for k in batches[0]}


def run(ctx: Context) -> dict:
    tr = ctx.traffic
    prog = Program(ctx)
    for i in range(len(prog.pool)):
        prog.call(i)
    _sync(ctx.device)
    ctx.mark("warmed up")
    setup_s = time.perf_counter() - ctx.t0
    on_card = torch.device(ctx.device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    pick = random.Random(ctx.seed_of("sample"))
    kept: List = []
    times: List[float] = []
    out_bytes = 0
    start = time.perf_counter()
    end = start
    while end - start < ctx.seconds:
        t0 = time.perf_counter()
        out = prog.call(len(times))
        _sync(ctx.device)
        end = time.perf_counter()
        times.append(end - t0)
        n = len(times)
        out_bytes = held_bytes(out)
        if len(kept) < tr["sample"]:
            kept.append((n - 1, out))
        else:
            j = pick.randrange(n)
            if j < tr["sample"]:
                kept[j] = (n - 1, out)
        del out
    window_s = end - start
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    trace = None
    if ctx.trace:
        trace = trace_steps(lambda i: prog.call(i), tr["traced_steps"],
                            lambda: _sync(ctx.device))
    spec, pool = prog.spec, prog.pool
    del prog
    if on_card:
        torch.cuda.empty_cache()
    scenes = []
    for i, out in kept:
        ref = reference(ctx, spec, pool[i % len(pool)], tr["ref_rows"])
        scenes.append(gaps(out, ref))
    readings = worst_of(scenes)
    failed = sum(not judge(s, ctx.limits) for s in scenes)
    return dict(setup_s=setup_s, window_s=window_s, steps=len(times),
                peak=peak, spec=spec, attempted=len(times),
                held=pools.nbytes(pool) + len(kept) * out_bytes,
                failed=failed, readings=readings, trace=trace,
                e2e={"infer_scenes_per_s": len(times) * tr["batch"]
                     / window_s,
                     "infer_batch_ms_p95": float(np.percentile(
                         np.array(times) * 1e3, 95))})


def calibrate(ctx: Context, precs) -> dict:
    """The limits' readings for one seed, each against the exact reference:
    the program's outputs on each batch of the pool, the program with a
    fault planted (half of each batch left out, one scene's outputs
    altered, and :mod:`benchmark.faults`' weight faults), and the reference
    in each control's precision."""
    tr = ctx.traffic
    got = {}
    for fault in (None, "half", "altered") + faults.WEIGHT_FAULTS:
        prog = Program(dataclasses.replace(ctx, fault=fault))
        got[fault or "program"] = [tuple(o.clone() for o in prog.call(i))
                                   for i in range(len(prog.pool))]
        spec, pool = prog.spec, prog.pool
        del prog
        if torch.device(ctx.device).type == "cuda":
            torch.cuda.empty_cache()
    out = {k: [] for k in list(got) + [p.name for p in precs]}
    for i, batch in enumerate(pool):
        ref = reference(ctx, spec, batch, tr["ref_rows"])
        for k, v in got.items():
            out[k].append(gaps(v[i], ref))
        for p in precs:
            low = reference(ctx, spec, batch, tr["ref_rows"], p)
            out[p.name].append(gaps((torch.sigmoid(low[0]),
                                     torch.sigmoid(low[1]), low[2]), ref))
    return {k: worst_of(v) for k, v in out.items()}
