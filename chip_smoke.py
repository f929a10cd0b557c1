"""Smoke test of the PyTorch port of STrajNet on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``strajnet_tpu_torch/csrc`` (one nvcc
process per source, started together) and holds each against its plain
PyTorch version at the shapes of the flagship model (batch 16, bf16):

- K1 ``swin_block`` and K2 ``swin_block_bwd`` at the four Swin-block
  geometries, K3 ``window_attention`` and K4 ``window_attention_bwd`` at the
  same four; all four also at a ragged window count (``[3, 40, 40, C]``:
  75 windows for blocks that take two at a time) and twice on the same
  inputs (the forwards and dx bit-identical); K3 and K4 refusing 32x32
  windows, which neither route takes, before a launch; the split-K pass
  that sums K2's and K4's weight gradients alone against
  ``A.float().T @ B.float()``;
- K5 ``warp_gather_fwd`` and K6 ``warp_gather_bwd`` at ``[128, 256, 256, 1]``,
  K6 also on a smooth flow (neighbouring queries share corners), on queries
  at the rows where its bands meet, and at several band counts;
- K7 ``decoder_tail`` at ``[128, 128, 128, 96] -> [128, 256, 256, 2]``, at
  image sides one under, at and one over what its tiles own, and twice;
- the general route of K1-K4 (``csrc/window_any.cu``) at ULTRA_TINY's,
  TINY's, the Swin-B and the flagship's widths in f32 and bf16 and at
  windows of 49, 144 and 256 tokens (``ANY_GEOMETRIES``), each twice
  against its plain version (the two runs bit-identical; K2 and K4 in f32
  within the limits of their bf16 operands, ``ANY_BF16_OPERANDS_*``), with
  the library's kernels a call counted (K1 at most 5, K2 at most 13, K3 at
  most 3, K4 at most 7) and timed beside it, the general K1-K4 broken down
  by kernel (K3's products beside ``torch.addmm`` on the same shapes); at
  the edges of the route (``ANY_EDGES``: K3 at its largest f32 and bf16
  widths and in f32 at 256 tokens, K2 in f32 at head_dim 64 and 256
  tokens), twice against plain, untimed; the forward attention's grid
  (``attn_plan``) against its Python twin at all of these; and of
  K7 (``csrc/decoder_tail_any.cu``) at the model's tail widths in f32, at
  64 -> 32 channels in bf16, at the f32 flagship tail and at a ragged
  geometry (``ANY_TAILS``), twice, timed in rounds and broken down by
  kernel at the f32 flagship tail; the flagship shapes launching none of
  them;
- the SwinV2 block on the general route (``ops/swinv2_block.py``:
  ``swinv2_any_fwd`` and ``swinv2_any_bwd``) in bf16 at the SwinV2-B
  configuration's four widths at batch 16 (``V2_GEOMETRIES``: C 128 on a
  shifted 128^2 grid, C 512 with 16 heads, C 1024 in one unshifted 16x16
  window), a head of each past the logit scale's clamp, against the plain
  block (``V2_BF16_*``, ``V2_DTAU_*``), the kernels of one call counted
  from counters zeroed just before (7 and 17: the attention stage fused),
  timed beside the plain block and broken down by kernel at C 128.

Then it drives the port's paths through their entry points with seeded
random weights at ``STRAJNET_CONFIG``, batch 16: the forward through the
kernel and through the plain path; three synthetic batches through
``infer.runner.run_shard``, whose submission it parses back; and three
training steps through ``train.state.create_train_state`` and
``train.step.make_train_step``, whose first step it repeats with the
``"block_fwd"`` mode and with the plain path (loss, whole gradient and
every parameter's gradient against the kernel path's), then in the ``"attn"``
mode against the plain path and once more with ``remat_encoder`` against the
``"attn"`` step without it (peak memory of both); and the gradient of
``core.sampling.flow_warp_origin`` with respect to the warped image, the one
path that reaches K6 (the loss warps ground truth). The evaluation path
follows: two synthetic batches through ``infer.evaluate.evaluate_batches``
(the eval step: forward, loss, challenge metrics) on a model with
``use_pallas_attention="attn"`` and the decoder-tail kernel, so K3 runs in
all eight Swin blocks and K7 in both tails, held against the same loop on
the plain path, and timed once more on the compact feed (uint8 grids, f16
map) that ``infer/evaluate.py`` reads by default; then on six batches of
each feed with the device prefetch (``data/pipeline.py::
prefetch_to_device``) and with the pageable copies it replaced, in turns.
Last, the training loop, ``train.loop.train``, on synthetic compact-feed
batches handed in through ``batches=`` (6 train, 2 val): one epoch from a
step-0 checkpoint, a run that resumes at epoch 1 and takes epoch 2 (the
log, the checkpoints, 8/8/1 launches of K1/K2/K5 per train step and 8/2 of
K1/K5 per val step, the newest checkpoint restoring bit for bit, a
checkpoint's save and restore times), the bare ``make_train_step`` on the
same batches on the card twice, a third epoch; then three steps and one val
batch of ``STRAJNET_TRAIN_PY_CONFIG`` (no FG-MSA). Then the model variants
(phase ``variants``): three training steps each of ``STRAJNET_CONFIG`` and
of its map variant (``actor_only=False``: the centerline encoder and the
per-waypoint map blocks) on the same batches, step time and peak memory side
by side, and the map variant's first step on the plain path against the
kernel path's; one eval-mode forward per variant group (``sep_actors``,
``deform_kv``, the ConvLSTM stages, ``sep_conv`` with the tail kernel after
its ConvLSTM, ``ape``, no pyramid, the 256² geometry without
``large_input``, the wirings without a flow stage, ``rep_res=False`` at
batch 8) through the kernels against the plain path; FG-MSA's rel-pos bias
as a blend of table windows against the direct gather it replaced, the two
held against each other in f32 and timed forward and backward. Last, the
offline preprocessor (phase ``preprocess``): the C library's sine and cosine
and the fused multiply-add of ``core/libm.py`` on the card against the CPU,
four synthetic WOMD scenarios at full size (128 agents x 91 steps, 20 000
roadgraph samples) rasterized by ``Processor.raster_features`` on the card
and on its CPU twin (0 cells may differ; ms a scenario, scenarios/s, peak
memory, the renders one by one, a profile), and their actor and centerline
vectors against the record's shapes; it launches no kernel. Last, the
measuring tools (phase ``tools``): the bench (``tools/bench.py``: forward
and training step at batch 16, forward at 32; min <= median <= max, the
model FLOP utilisation in (0, 1.05], 8 K1 a forward and 8/8/1 K1/K2/K5 a
step), the forward-mode probe (tails ``xla`` and ``infer`` x modes
``block`` and ``attn``; ``infer`` runs K7 twice a forward), the parts
profile over the five coarse parts, ``entry()``'s forward bit-equal to the
module's, the forward with ``spatial_shard`` bit-equal to the one without,
and ``sample``'s eight option combinations and ``dense_image_warp`` on the
card against the CPU. The launch
counters are set to zero just before each path and read just after. Any failed check
raises and the script exits non-zero. The last line is a JSON object naming
the device; the line before it lists each kernel with its launches on those
paths, its error against the plain version, its times and its bound.

Phase ``tp``, tensor parallelism (``parallel/mesh.py``): two ``gloo`` rank
processes on this card on a 1 x 2 ``('data', 'model')`` mesh take the
flagship step at batch 16 (K1 8, K2 8 and K5 1 on each rank; K3 8 and K4 8
in the ``"attn"`` mode) and an eval step (K1 8, K5 2) against one process on
the same batches (loss, terms, metrics, whole gradient), and after four
steps the replicated parameters are bit-equal on both ranks; the forward
with ``spatial_shard`` is bit-equal to the one without and its hinted
activations are recorded with their split over ``'model'``; each rank's ms
per step, peak memory and the bytes moved over each axis beside one
process's; then
``tools/graft_entry.py::dryrun_multichip`` over four ranks on a 2 x 2 mesh.

Phase ``widths``: whole models whose widths or element type the wgmma
kernels are not built for, kernels on against the plain path
(``use_pallas_attention=False``, the naive tail) on the same weights: the
flagship in f32 (forward at batch 2, 8 general K1), the Swin-B width in bf16
(``SWIN_B_CONFIG``; forward and one training step at batch 4, 8 general K1
and K2), TINY in the ``"block"`` and ``"attn"`` modes with the tail kernel
(forward and a step each at batch 4: general K1/K2 or K3/K4, 2 general K7 a
forward), and the SwinV2-B preset (``STRAJNET_SWINV2_B_CONFIG``; forward and
one training step at batch 2, 26 SwinV2 blocks on the general route, no
Swin-v1 block; 26 fused attention stages a forward, 52 a step). Then the
SwinV2 block's attention stage alone at
``V2_GEOMETRIES`` (batch 16, shifted and not): the fused kernel against the
two launches it replaced (q', k' and raw q, k bit for bit, merged and the
row statistics as ``v2_held`` holds a block), both timed in turns, with the
stage's bound by bytes and by operations, and summed over a pass of the 26
blocks. The kernels line also lists the general route of each kernel and the
SwinV2 block's forward and backward with their launches on these paths.

``--phases`` runs a subset (kernels, forward, serve, train, eval, loop,
variants, ddp, tp, preprocess, tools, widths) while developing; with no
arguments every phase runs.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from strajnet_tpu_torch import _build  # noqa: E402
from strajnet_tpu_torch.core.sampling import (  # noqa: E402
    BorderType, PixelType, ResamplingType, dense_image_warp, flow_warp_origin,
    ref_points, rpe_bias, sample)
from strajnet_tpu_torch.config import (  # noqa: E402
    STRAJNET_CONFIG, STRAJNET_SWINV2_B_CONFIG, STRAJNET_TRAIN_PY_CONFIG,
    TINY_MODEL_CONFIG,
    WAYMO_OGM_TASK_CONFIG, WAYMO_TASK_CONFIG, LossConfig, ModelConfig,
    TaskConfig, TrainConfig)
from strajnet_tpu_torch.core.libm import cosf, fmaf, sinf  # noqa: E402
from strajnet_tpu_torch.data.pipeline import prefetch_to_device  # noqa: E402
from strajnet_tpu_torch.data.preprocess import Processor  # noqa: E402
from strajnet_tpu_torch.data.raster import (  # noqa: E402
    render_backward_flow, render_occupancy)
from strajnet_tpu_torch.data.schema import SHAPES  # noqa: E402
from strajnet_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from strajnet_tpu_torch.data.womd import (  # noqa: E402
    NUM_AGENTS, NUM_FUTURE_STEPS, NUM_PAST_STEPS, NUM_ROADGRAPH_SAMPLES)
from strajnet_tpu_torch.infer import evaluate as evaluate_mod  # noqa: E402
from strajnet_tpu_torch.infer.evaluate import evaluate_batches  # noqa: E402
from strajnet_tpu_torch.infer.proto import iter_fields  # noqa: E402
from strajnet_tpu_torch.infer.runner import run_shard  # noqa: E402
from strajnet_tpu_torch.infer.submission import (  # noqa: E402
    SCENARIO_ID, SCENARIO_WAYPOINTS, SUBMISSION_SCENARIO_PREDICTIONS)
from strajnet_tpu_torch.models.strajnet import STrajNet, init_params  # noqa: E402
from strajnet_tpu_torch.models.swin import (  # noqa: E402
    BasicLayerDecoder, SwinTransformerBlock, SwinV2TransformerBlock)
from strajnet_tpu_torch.objective.loss import (  # noqa: E402
    OGMFlowLoss, split_pred_waypoints, true_waypoints_from_batch)
from strajnet_tpu_torch.objective.metrics import (  # noqa: E402
    apply_sigmoid_to_occupancy_logits, compute_occupancy_flow_metrics,
    print_metrics)
from strajnet_tpu_torch.ops import swinv2_block as v2  # noqa: E402
from strajnet_tpu_torch.ops import window_attention as wa  # noqa: E402
from strajnet_tpu_torch.ops import decoder_tail as dtl  # noqa: E402
from strajnet_tpu_torch.ops.decoder_tail import (  # noqa: E402
    decoder_tail, decoder_tail_phase, decoder_tail_reference)
from strajnet_tpu_torch.ops.swin_block import (  # noqa: E402
    GRAD_NAMES, atb_accum, kernel_route, kernel_smem_bytes, swin_block,
    swin_block_backward_reference, swin_block_bwd, swin_block_reference,
    token_blocked, window_any_fwd_launches, window_any_launches,
    window_any_v2_attn_launches)
from strajnet_tpu_torch.ops.warp_gather import (  # noqa: E402
    band_edge_rows, bwd_band_rows, gather_corners_reference, scatter_corners_reference,
    warp_gather_bwd, warp_gather_fwd)
from strajnet_tpu_torch.ops.rpe_window import rpe_window_bias  # noqa: E402
from strajnet_tpu_torch.ops.windows import shifted_window_mask  # noqa: E402
from strajnet_tpu_torch.parallel import mesh as tp  # noqa: E402
from strajnet_tpu_torch.parallel.ddp import (  # noqa: E402
    allreduce_sum_hook, destroy, init_distributed, unwrap)
from strajnet_tpu_torch.train.checkpoints import (  # noqa: E402
    CheckpointManager)
from strajnet_tpu_torch.train.loop import train  # noqa: E402
from strajnet_tpu_torch.train.state import create_train_state  # noqa: E402
from strajnet_tpu_torch.train.step import (  # noqa: E402
    ensure_f32, make_eval_step, make_predict_step, make_train_step,
    zero_loss_sums)
from strajnet_tpu_torch.tools import (  # noqa: E402
    bench, graft_entry, probe_forward_modes, profile_parts)
# K1 .. K7 in COUNTERS' order, the order of the kernels line
from strajnet_tpu_torch.tools.timing import (  # noqa: E402
    COUNTERS, GENERAL_COUNTERS, PEAK_BF16_FLOPS, PEAK_F32_FLOPS,
    PEAK_HBM_BYTES, PEAK_TF32X3_FLOPS, bound,
    cuda_ms, gpu_identity, kernel_ms, read_counters, read_general_counters,
    reset_counters, spread)

BATCH = 16
KERNEL_SOURCES = ("swin_block", "swin_block_bwd", "warp_gather",
                  "window_attention", "decoder_tail", "window_any",
                  "decoder_tail_any")
# K1 vs its plain version, both bf16 with f32 accumulation but rounding at
# different points: at most 4 bf16 ulps of the largest output, and 1 - cos
# at bf16 noise level.
K1_MAX_ABS_REL = 2.0 ** -5
K1_ONE_MINUS_COS = 1e-4
# K2 vs its plain version, for dx and each of the 13 gradients. Both round
# at the same points, but their f32 sums run in another order (and with
# atomics, in an order that varies), so a bf16 operand can round the other
# way; the parameter gradients then sum 10^5-10^6 such tokens. Limits are
# relative to the largest entry of the plain result: 2 bf16 ulps of it (dx
# is bf16), and 1 - cos at bf16 noise level.
K2_MAX_ABS_REL = 2.0 ** -6
K2_ONE_MINUS_COS = 1e-4
# The split-K pass against the f32 product of the same bf16 operands: only
# the order of the f32 sums differs (a few hundred token slices added with
# atomics), relative to the largest entry of the product.
SPLIT_K_MAX_ABS_REL = 1e-5
# K2's parameter gradients in two runs on the same inputs: f32 atomics in an
# order that varies, relative to the largest entry.
K2_REPEAT_MAX_ABS_REL = 1e-4
# K3 and K4 against their plain versions, which round at the kernels' own
# points; f32 sums run in another order (K4's with atomics), so a bf16
# operand can round the other way. The limits are K1's and K2's.
K3_MAX_ABS_REL = 2.0 ** -5
K3_ONE_MINUS_COS = 1e-4
K4_MAX_ABS_REL = 2.0 ** -6
K4_ONE_MINUS_COS = 1e-4
# K4's parameter gradients in two runs on the same inputs: f32 atomics in an
# order that varies, relative to the largest entry.
K4_REPEAT_MAX_ABS_REL = 1e-6
# K7 against the naive composition in bf16 (cuDNN rounds its sums once, as
# the kernel does, but sums in another order) and, at a small shape, against
# the f32 composition of the same bf16 inputs with TF32 off.
K7_MAX_ABS_REL = 2.0 ** -6
K7_ONE_MINUS_COS = 1e-4
# The eval path, kernels ("attn" + decoder-tail kernel) vs the plain path,
# means over two batches. Losses and metrics are held relative to the plain
# path's value (with seed-0 weights the AUCs and IoUs are small numbers, so
# an absolute limit would hold nothing); the absolute term only serves a
# metric whose value is 0 on both paths. Four times the worst readings on an
# H100: loss 2.6e-4 (observed_xe), metric 4.8e-4 (observed_auc; flow_epe
# 1.8e-4).
EVAL_LOSS_RTOL = 2e-3
EVAL_METRIC_RTOL = 2e-3
EVAL_METRIC_ATOL = 1e-6
# K5 is an exact copy of image values. K6 sums f32 with atomics in varying
# order: relative to the largest entry of the plain scatter.
K5_MAX_ABS = 0.0
K6_MAX_ABS_REL = 1e-5
# Whole bf16 forward, kernel path vs plain path: the block-level rounding
# differences pass through ~60 more bf16 layers.
FWD_ONE_MINUS_COS = 1e-3
# bf16 kernel forward vs the f32 plain forward of the same weights.
F32_ONE_MINUS_COS = 1e-3
# First training step, "block_fwd" and plain path vs the kernel path: the
# total loss (bf16 forwards that differ by rounding only), the whole
# gradient vector by cosine, and every parameter's gradient by cosine (the
# worst leaf). "block_fwd" shares the kernel path's forward, so its loss is
# the same number and its gradients differ by K2's sum order only; the plain
# path also rounds its forward elsewhere. The limits sit a few times above
# the readings on an H100 (loss 0 and 1.9e-3; gradient 4.3e-7 and 1.9e-5;
# worst leaf, a rel-pos bias table each time, 1.8e-4 and 6.6e-4). The
# "attn" step with remat_encoder against the same step without: the same
# kernels on the same inputs, so the same loss, and gradients that differ
# only by the order of f32 atomics.
STEP_LOSS_RTOL = {"block_fwd": 1e-6, False: 1e-2, "remat": 0.0}
STEP_GRAD_ONE_MINUS_COS = {"block_fwd": 1e-5, False: 1e-4, "remat": 1e-6}
STEP_LEAF_ONE_MINUS_COS = {"block_fwd": 1e-3, False: 3e-3, "remat": 1e-5}
# Its gradient is zero but for rounding (it shifts every logit of a softmax
# row alike), so its direction is noise.
ZERO_GRAD_LEAVES = ("fg_msa_layer.proj_k.bias",)
# (H = W, C, heads, shift, blocks of this geometry in one forward)
GEOMETRIES = ((128, 96, 3, 0, 2), (128, 96, 3, 4, 2), (64, 192, 6, 4, 2),
              (32, 384, 12, 4, 2))
MODEL_KEYS = ("ogm", "map_image", "actors", "occl_actors", "centerlines",
              "vec_flow")
PHASES = ("kernels", "forward", "serve", "train", "eval", "loop", "variants",
          "ddp", "tp", "preprocess", "tools", "widths")
# The general route of K1-K4 (csrc/window_any.cu) and K7
# (csrc/decoder_tail_any.cu) against the plain versions. In f32, with TF32
# off, the same f32 arithmetic summed in another order: forwards within 1e-4
# of the largest entry of the plain result (K1, K3, K7). In bf16 the limits
# of the wgmma route: K1_*, K2_*, K3_*, K4_*, K7_*.
ANY_F32_FWD_MAX_ABS_REL = 1e-4
# K2 and K4 in f32 round every backward product's operands and results to
# bf16 (q, k, v, p, dO, ds, dqkv; K2 also dz2, dz1, datt, g1, h1, h2,
# merged), as the JAX kernels and their plain oracles
# (swin_block_backward_reference and window_attention_backward_reference
# with operand_dtype=bf16) do: an f32 sum that differs in its last bit
# rounds to the neighbouring bf16 value, so the oracle's own answer moves by
# bf16 steps when its f32 sums change order (tests/test_torch_k4_f32_check.py:
# 1.8e-3 of max|ref| in K4's dx at the flagship's last width). Their limits
# are then those of bf16 operands, the bf16 K4's: 2^-6 of the largest entry
# (8.9x that spread), and 1 - cos within 1e-6 (49x the spread's 2.05e-8,
# 100x under the bf16 K4's).
ANY_BF16_OPERANDS_MAX_ABS_REL = 2.0 ** -6
ANY_BF16_OPERANDS_ONE_MINUS_COS = 1e-6
# (B, H = W, C, heads, window, MLP width, shift, dtype): ULTRA_TINY's stage
# 0 without and with the shift, TINY's widest stage at its C, the Swin-B
# width, the flagship's last width in f32, windows of 256 tokens, and two
# windows of SWIN_VARIANTS: the first stage of Swin-T/224 (7 x 7, 49 tokens)
# and of Swin-B/384 (12 x 12, 144 tokens).
ANY_GEOMETRIES = (
    (4, 32, 8, 1, 4, 16, 0, "float32"),
    (4, 32, 8, 1, 4, 16, 2, "float32"),
    (2, 64, 64, 4, 4, 256, 0, "float32"),
    (2, 128, 128, 4, 8, 512, 4, "bfloat16"),
    (2, 32, 384, 12, 8, 1536, 4, "float32"),
    (1, 32, 64, 2, 16, 256, 8, "bfloat16"),
    (2, 56, 96, 3, 7, 384, 3, "float32"),
    (1, 96, 128, 4, 12, 512, 6, "bfloat16"),
)
# Kernels a call of the general K1, K2, K3 and K4 may launch
# (csrc/window_any.cu: 5, 13, 3 and 7).
ANY_K1_MAX_KERNELS = 5
ANY_K2_MAX_KERNELS = 13
ANY_K3_MAX_KERNELS = 3
ANY_K4_MAX_KERNELS = 7
# (B, H = W, C, heads, window, MLP width, shift, dtype, what) at the edges of
# the general route, checked like ANY_GEOMETRIES (twice, bit-identical,
# against plain) but not summed into the times: K3 at C 576 over 121-token
# windows in f32 and at C 1024 over 225-token windows in bf16, K3 in f32 at
# 256 tokens, and K2 in f32 at head_dim 64 and 256 tokens, where q, k, v and
# dO held whole would take 278,528 bytes of shared memory.
ANY_EDGES = (
    (1, 22, 576, 12, 11, 576, 5, "float32", "k3 f32, C 576, 121 tokens"),
    (1, 30, 1024, 32, 15, 1024, 7, "bfloat16", "k3 bf16, C 1024, 225 tokens"),
    (1, 32, 48, 2, 16, 96, 8, "float32", "k3 f32, 256 tokens"),
    (1, 32, 64, 1, 16, 256, 8, "float32", "k2 f32, head_dim 64"),
)
# Rounds of plain / kernel / kernel / plain behind each time of the general
# route (phase kernels) and of phase widths, printed as min / median / max
# over the rounds; the kernels line takes the medians.
TIMING_ROUNDS = 5
# (N, H = W, Cin, Cmid, dtype) of the general K7: the model's tail widths in
# f32, narrower ones in bf16, the tail of ModelConfig(dtype="float32") at
# batch 16 (the model at full width) and a ragged geometry (Cin 24, Cmid
# 20, a side of 37). The sum over the first ANY_TAILS_BEFORE is printed
# apart, to compare with earlier readings over those tails alone.
ANY_TAILS = ((16, 64, 96, 48, "float32"), (16, 32, 64, 32, "bfloat16"),
             (16, 128, 96, 48, "float32"), (3, 37, 24, 20, "bfloat16"))
ANY_TAILS_BEFORE = 2
# Phase "widths": whole models through the general route against the plain
# path. f32: the largest entry's relative error of the forward; bf16 and the
# steps: the limits of the flagship's checks (forward 1-cos, loss within 1%
# of the plain path's, whole gradient 1-cos).
WIDTHS_F32_MAX_ABS_REL = 1e-3
WIDTHS_ONE_MINUS_COS = 1e-3
WIDTHS_LOSS_RTOL = 1e-2
WIDTHS_GRAD_ONE_MINUS_COS = 1e-4
# The Swin-B width at the flagship's geometry; FG-MSA's eight heads span the
# 512-channel bottleneck with 64 channels each (it takes heads x channels
# equal to its input width).
SWIN_B_CONFIG = ModelConfig(embed_dim=128, num_heads=(4, 8, 16),
                            fgmsa_head_channels=64)
# The SwinV2 block on the general route, bf16, window 16, MLP width 4C, at
# batch 16: (H = W, C, heads, shift, blocks of this width in a forward of
# STRAJNET_SWINV2_B_CONFIG, half of them unshifted but at 16^2) for its
# flow stage and first stage, its second, its third and its last (one
# unshifted window).
V2_GEOMETRIES = ((128, 128, 4, 8, 4), (64, 256, 8, 8, 2),
                 (32, 512, 16, 8, 18), (16, 1024, 32, 0, 2))
# The limits of tests/test_torch_swinv2_kernels.py. The kernels and the
# plain bf16 block round their intermediates to bf16 at their own places,
# and the cosine logits multiply a rounding of q or k by the logit scale
# (up to 100), so neither is the other's truth: both are held against the
# plain block in f32 on the same bf16 inputs (TF32 off), the kernels no
# further from it than V2_BF16_FACTOR times the plain bf16 block is, in the
# largest entry's error and in 1 - cos, with floors of one bf16 rounding
# where the plain block comes closer. dtau sums every token's q^ . dq^,
# whose terms cancel, from dS taken off p rounded to bf16: 2^-3 of its
# largest entry and 1 - cos 1e-3.
V2_BF16_FACTOR = 2.0
V2_BF16_FLOOR = 2.0 ** -8
V2_BF16_COS_FLOOR = 1e-5
V2_DTAU_MAX_ABS_REL = 2.0 ** -3
V2_DTAU_ONE_MINUS_COS = 1e-3
# FG-MSA's rel-pos bias, the window form against the direct gather, f32:
# the bias and its two gradients by cosine.
RPE_ONE_MINUS_COS = 1e-4
# The variants phase's eval-mode forwards: (name, flags replaced on
# STRAJNET_CONFIG, batch, kernel launches per forward). rep_res=False
# reshapes each residual to [-1, 8, ...]: the JAX package runs it at batch 8.
VARIANT_FORWARDS = (
    ("sep_actors", dict(sep_actors=True), BATCH, dict(k1=8)),
    ("deform_kv", dict(deform_kv=True), BATCH, dict(k1=8)),
    ("conv_cnn", dict(conv_cnn=True), BATCH, dict(k1=8)),
    ("sep_conv + tail kernel",
     dict(sep_conv=True, use_pallas_decoder_tail=True), BATCH,
     dict(k1=8, k7=2)),
    ("ape", dict(ape=True), BATCH, dict(k1=8)),
    ("use_pyramid=False", dict(use_pyramid=False), BATCH, dict(k1=8)),
    ("large_input=False at 256^2",
     dict(large_input=False, input_size=(256, 256)), BATCH, dict(k1=8)),
    ("no_map, flow_sep=False, flow_sep_decode=False",
     dict(no_map=True, flow_sep=False, flow_sep_decode=False), BATCH,
     dict(k1=6)),
    ("sep_encode=False, use_flow=False, flow_sep_decode=False at 256^2",
     dict(sep_encode=False, use_flow=False, flow_sep_decode=False,
          large_input=False, input_size=(256, 256)), BATCH, dict(k1=6)),
    ("rep_res=False", dict(rep_res=False), 8, dict(k1=8)),
)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def one_minus_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return 1.0 - float((a @ b) / (a.norm() * b.norm()))


def block_work(h: int, c: int, heads: int, shift: int, backward: bool):
    """FLOPs and bytes one Swin block at batch 16 needs, forward or backward.

    Forward, per token: 24 C^2 for the four weight products and 256 C for
    the two 64-token attention products. The backward recomputes the forward
    and runs two products for each of the forward's (72 C^2 + 768 C). Bytes:
    x in and out (and dy in) in bf16, the parameters in their dtypes, mask
    and drop-path once; the backward also writes the f32 gradients.
    """
    tokens = BATCH * h * h
    flops = tokens * (24 * c * c + 256 * c) * (3 if backward else 1)
    params = 12 * c * c * 2 + 4 * c * 2 + (4 + 4 + 1) * c * 4 \
        + heads * 4096 * 4
    extra = (h // 8) ** 2 * 4096 * 4 * (1 if shift else 0) + BATCH * 2 * 4
    acts = tokens * c * 2 * (3 if backward else 2)
    grads = (12 * c * c + 13 * c + heads * 4096) * 4 if backward else 0
    return flops, acts + params + extra + grads


def block_inputs(h: int, c: int, heads: int, shift: int,
                 g: torch.Generator, batch: int = BATCH):
    dev, bf = "cuda", torch.bfloat16

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    args = (r(batch, h, h, c).to(bf),
            r(c, 3 * c, scale=c ** -0.5).to(bf), r(3 * c, scale=0.1).to(bf),
            r(c, c, scale=c ** -0.5).to(bf), r(c, scale=0.1).to(bf),
            r(heads, 64, 64, scale=0.3),
            1 + r(c, scale=0.1), r(c, scale=0.1),
            1 + r(c, scale=0.1), r(c, scale=0.1),
            r(c, 4 * c, scale=c ** -0.5).to(bf), r(4 * c, scale=0.1),
            r(4 * c, c, scale=(4 * c) ** -0.5).to(bf), r(c, scale=0.1))
    mask = (torch.from_numpy(shifted_window_mask(h, h, 8, shift)).to(dev)
            if shift else None)
    dp = torch.rand(batch, 2, generator=g, device=dev) * 1.2
    return args, mask, dp


def build_resources(log: str) -> dict:
    """{entry name: (registers, static shared bytes, spill bytes)} of every
    kernel of a build, from nvcc's ``-Xptxas -v`` output: the entry's own
    lines (the functions it calls without inlining follow with lines of
    their own)."""
    found, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            found[name] = [None, 0, None]
        elif name is not None and "spill stores" in line:
            if found[name][2] is None:
                found[name][2] = int(
                    line.split("bytes spill stores")[0].split(",")[-1])
        elif name is not None and "Used" in line and "registers" in line:
            found[name][0] = int(line.split("Used")[1].split("registers")[0])
            smem = re.search(r"(\d+) bytes smem", line)
            found[name][1] = int(smem.group(1)) if smem else 0
            name = None
    return {n: tuple(v) for n, v in found.items()}


def kernel_resources(log: str, kernel: str) -> dict:
    """{C: (registers, spill bytes)} of a kernel templated on the channel
    width (C = 0 for one that is not), from ``build_resources``."""
    found = {}
    for name, (regs, _, spill) in build_resources(log).items():
        if kernel + "ILi" in name:
            found[int(name.split(kernel + "ILi")[1].split("E")[0])] = (
                regs, spill)
        elif kernel + "E" in name:
            found[0] = (regs, spill)
    return dict(sorted(found.items()))


def check_split_k(g: torch.Generator) -> dict:
    """The split-K pass ``dW += A^T B`` alone at K2's four operand shapes of
    the first and the last flagship stage, from the token-blocked layout the
    backward window kernels (K2, K4) write."""
    total, total_bound = 0.0, 0.0
    for h, c in ((128, 96), (32, 384)):
        tokens = BATCH * h * h
        for m, n in ((c, 3 * c), (c, c), (c, 4 * c), (4 * c, c)):
            a = torch.randn(tokens, m, generator=g,
                            device="cuda").to(torch.bfloat16)
            b = torch.randn(tokens, n, generator=g,
                            device="cuda").to(torch.bfloat16)
            want = a.float().t() @ b.float()
            a, b = token_blocked(a), token_blocked(b)
            got = atb_accum(a, b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(err <= SPLIT_K_MAX_ABS_REL * scale,
                  f"split-K [{tokens},{m}]^T [{tokens},{n}] max_abs_err "
                  f"{err} <= {SPLIT_K_MAX_ABS_REL} * {scale}")
            dst = torch.zeros(m, n, device="cuda")
            ms = kernel_ms(lambda: atb_accum(a, b, dst), iters=10)
            bound_ms, by = bound(2.0 * m * n * tokens,
                                 (m + n) * tokens * 2 + m * n * 4)
            total += ms
            total_bound += bound_ms
            print(f"split-K [{tokens},{m}]^T [{tokens},{n}]: "
                  f"max_abs_err={err:.3e} (max|ref|={scale:.1f}) "
                  f"ms={ms:.4f} bound_ms={bound_ms:.4f} ({by})")
    return dict(ms=total, bound_ms=total_bound)


def check_ragged_and_repeat(g: torch.Generator) -> None:
    """K1 and K2 at [3, 40, 40, C], shift 4: 75 windows, an odd count for
    blocks that take two per step, each window with its own mask; and both
    kernels twice on the same inputs."""
    for c, heads in ((96, 3), (192, 6), (384, 12)):
        args, mask, dp = block_inputs(40, c, heads, 4, g, batch=3)
        dp[2, :] = 0.0
        dy = torch.randn(args[0].shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        kw = dict(window_size=8, num_heads=heads)
        with torch.no_grad():
            y = swin_block(*args, mask, dp, **kw)
            y2 = swin_block(*args, mask, dp, **kw)
            dx, grads = swin_block_bwd(*args, mask, dp, dy, **kw)
            dx2, grads2 = swin_block_bwd(*args, mask, dp, dy, **kw)
            torch.cuda.synchronize()
            ref = swin_block_reference(*args, mask, dp, **kw)
            rdx, rgrads = swin_block_backward_reference(*args, mask, dp, dy,
                                                        **kw)
        check(torch.equal(y, y2), f"K1 C={c}: two runs bit-identical")
        check(torch.equal(dx, dx2), f"K2 C={c}: dx of two runs bit-identical")
        check(torch.equal(dx[2], dy[2]), f"K2 C={c} ragged: dx == dy where "
              "both branches are dropped")
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        check(err <= K1_MAX_ABS_REL * scale and
              one_minus_cos(y, ref) <= K1_ONE_MINUS_COS,
              f"K1 ragged C={c}: max_abs_err {err} <= {K1_MAX_ABS_REL} * "
              f"{scale}")
        worst, drift = 0.0, 0.0
        for name, got, again, want in zip(("dx",) + GRAD_NAMES, (dx,) + grads,
                                          (dx2,) + grads2, (rdx,) + rgrads):
            gscale = float(want.float().abs().max())
            gerr = float((got.float() - want.float()).abs().max())
            check(gerr <= K2_MAX_ABS_REL * gscale and
                  one_minus_cos(got, want) <= K2_ONE_MINUS_COS,
                  f"K2 ragged C={c} {name}: max_abs_err {gerr} <= "
                  f"{K2_MAX_ABS_REL} * {gscale}")
            rep = float((got.float() - again.float()).abs().max()) / gscale
            check(rep <= K2_REPEAT_MAX_ABS_REL,
                  f"K2 C={c} {name}: two runs within "
                  f"{K2_REPEAT_MAX_ABS_REL}: {rep}")
            worst, drift = max(worst, gerr / gscale), max(drift, rep)
        print(f"ragged [3,40,40,{c}] (75 windows), twice: K1 max_abs_err="
              f"{err} (max|ref|={scale}), bit-identical; K2 worst "
              f"max_abs_err/max|ref|={worst:.2e}, dx bit-identical, "
              f"gradients of two runs within {drift:.1e}")


def check_attention_ragged_and_repeat(g: torch.Generator) -> None:
    """K3 and K4 at [3, 40, 40, C], shift 4 (75 windows: the last step of
    the persistent kernels has one window for two warpgroups), twice on the
    same inputs; and K3 and K4 refusing a width they are not built for
    before any launch."""
    for c, heads in ((96, 3), (192, 6), (384, 12)):
        args, mask, _ = block_inputs(40, c, heads, 4, g, batch=3)
        x, wqkv, bqkv, wproj, bproj, rel_bias = args[:6]
        dy = torch.randn(x.shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        bwd_args = (x, wqkv, bqkv, wproj, rel_bias, mask, dy)
        kw = dict(window_size=8, num_heads=heads)
        with torch.no_grad():
            y = wa.window_attention(*args[:6], mask, **kw)
            y2 = wa.window_attention(*args[:6], mask, **kw)
            dx, grads = wa.window_attention_bwd(*bwd_args, **kw)
            dx2, grads2 = wa.window_attention_bwd(*bwd_args, **kw)
            torch.cuda.synchronize()
            ref = wa.window_attention_reference(*args[:6], mask, **kw)
            rdx, rgrads = wa.window_attention_backward_reference(*bwd_args,
                                                                 **kw)
        check(torch.equal(y, y2), f"K3 C={c}: two runs bit-identical")
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        omc = one_minus_cos(y, ref)
        check(err <= K3_MAX_ABS_REL * scale and omc <= K3_ONE_MINUS_COS,
              f"K3 ragged C={c}: max_abs_err {err} <= {K3_MAX_ABS_REL} * "
              f"{scale}, 1-cos {omc}")
        check(torch.equal(dx, dx2), f"K4 C={c}: dx of two runs bit-identical")
        worst, drift = 0.0, 0.0
        for name, got, again, want in zip(
                ("dx",) + wa.GRAD_NAMES, (dx,) + grads, (dx2,) + grads2,
                (rdx,) + rgrads):
            gscale = float(want.float().abs().max())
            gerr = float((got.float() - want.float()).abs().max())
            check(gerr <= K4_MAX_ABS_REL * gscale and
                  one_minus_cos(got, want) <= K4_ONE_MINUS_COS,
                  f"K4 ragged C={c} {name}: max_abs_err {gerr} <= "
                  f"{K4_MAX_ABS_REL} * {gscale}")
            rep = float((got.float() - again.float()).abs().max()) / gscale
            check(rep <= K4_REPEAT_MAX_ABS_REL,
                  f"K4 C={c} {name}: two runs within "
                  f"{K4_REPEAT_MAX_ABS_REL}: {rep}")
            worst, drift = max(worst, gerr / gscale), max(drift, rep)
        print(f"ragged [3,40,40,{c}] (75 windows), twice: K3 max_abs_err="
              f"{err} (max|ref|={scale}) 1-cos={omc:.3e}, bit-identical; K4 "
              f"worst max_abs_err/max|ref|={worst:.2e}, dx bit-identical, "
              f"gradients of two runs within {drift:.1e}")

    # 32x32 windows (1024 tokens) are beyond both routes (the general one
    # takes 256 tokens): K3 and K4 raise before a launch, with or without
    # gradients
    args, _, _ = general_inputs(1, 32, 64, 2, 32, 64, 0, torch.bfloat16, g)
    args = args[:6]
    dy = torch.zeros_like(args[0])
    kw = dict(window_size=32, num_heads=2)
    before = (wa.window_attention.launches, wa.window_attention_bwd.launches,
              wa.window_attention.launches_any,
              wa.window_attention_bwd.launches_any)
    ins = [a.clone().requires_grad_(True) for a in args]
    for what, call in (
            ("K3", lambda: wa.window_attention(*args, None, **kw)),
            ("K3 with gradients", lambda: wa.window_attention(*ins, None,
                                                              **kw)),
            ("K4", lambda: wa.window_attention_bwd(
                *args[:4], args[5], None, dy, **kw))):
        try:
            call()
        except ValueError as e:
            print(f"{what} at 32x32 windows raises ValueError: {e}")
        else:
            check(False, f"{what} at 32x32 windows must raise")
    check((wa.window_attention.launches, wa.window_attention_bwd.launches,
           wa.window_attention.launches_any,
           wa.window_attention_bwd.launches_any) == before,
          "the refused K3 / K4 calls launched nothing")


def check_swin_block(g: torch.Generator) -> dict:
    """K1 against swin_block_reference; times summed over the eight blocks
    of one forward."""
    worst, ms, plain_ms, flops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0
    for h, c, heads, shift, count in GEOMETRIES:
        args, mask, dp = block_inputs(h, c, heads, shift, g)
        kw = dict(window_size=8, num_heads=heads)
        with torch.inference_mode():
            y = swin_block(*args, mask, dp, **kw)
            torch.cuda.synchronize()
            ref = swin_block_reference(*args, mask, dp, **kw)
            err = float((y.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            omc = one_minus_cos(y, ref)
            t_plain = kernel_ms(lambda: swin_block_reference(*args, mask, dp,
                                                           **kw), iters=10)
            t_kernel = kernel_ms(lambda: swin_block(*args, mask, dp, **kw),
                               iters=10)
        print(f"K1 swin_block [{BATCH},{h},{h},{c}] heads={heads} "
              f"shift={shift}: max_abs_err={err} (max|ref|={scale}) "
              f"1-cos={omc:.3e} kernel_ms={t_kernel:.4f} "
              f"plain_ms={t_plain:.4f}")
        check(bool(torch.isfinite(y).all()), "K1 output finite")
        check(err <= K1_MAX_ABS_REL * scale,
              f"K1 max_abs_err {err} <= {K1_MAX_ABS_REL} * {scale}")
        check(omc <= K1_ONE_MINUS_COS, f"K1 1-cos {omc} <= {K1_ONE_MINUS_COS}")
        worst = max(worst, err)
        ms += count * t_kernel
        plain_ms += count * t_plain
        fl, by = block_work(h, c, heads, shift, backward=False)
        flops += count * fl
        nbytes += count * by
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_swin_block_bwd(g: torch.Generator) -> dict:
    """K2 against swin_block_backward_reference: dx and the 13 gradients at
    the four geometries; times summed over the eight blocks of one step."""
    worst_abs, worst_rel = 0.0, 0.0
    ms, plain_ms, autograd_ms, flops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0
    for h, c, heads, shift, count in GEOMETRIES:
        args, mask, dp = block_inputs(h, c, heads, shift, g)
        dp[0, 0] = 0.0   # dropped samples: dx = dy through that branch
        dp[1, 1] = 0.0
        dp[2, :] = 0.0
        dy = torch.randn(args[0].shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        kw = dict(window_size=8, num_heads=heads)
        with torch.no_grad():
            dx, grads = swin_block_bwd(*args, mask, dp, dy, **kw)
            torch.cuda.synchronize()
            rdx, rgrads = swin_block_backward_reference(*args, mask, dp, dy,
                                                        **kw)
        report = []
        for name, got, ref in zip(("dx",) + GRAD_NAMES, (dx,) + grads,
                                  (rdx,) + rgrads):
            check(bool(torch.isfinite(got).all()), f"K2 {name} finite")
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            omc = one_minus_cos(got, ref)
            report.append(f"{name} {err / scale:.2e}/{omc:.1e}")
            check(err <= K2_MAX_ABS_REL * scale,
                  f"K2 {name} max_abs_err {err} <= {K2_MAX_ABS_REL} * {scale}")
            check(omc <= K2_ONE_MINUS_COS,
                  f"K2 {name} 1-cos {omc} <= {K2_ONE_MINUS_COS}")
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / scale)
        check(bool((dx[2] == dy[2]).all()),
              "K2: a sample with both branches dropped has dx == dy")

        def autograd_of_plain():
            ins = [t.detach().requires_grad_(True) for t in args]
            y = swin_block_reference(*ins, mask, dp, **kw)
            return torch.autograd.grad(y, ins, dy)

        with torch.no_grad():
            t_kernel = kernel_ms(lambda: swin_block_bwd(*args, mask, dp, dy,
                                                      **kw), iters=5)
            t_plain = kernel_ms(lambda: swin_block_backward_reference(
                *args, mask, dp, dy, **kw), iters=2)
        t_autograd = kernel_ms(autograd_of_plain, iters=2)
        print(f"K2 swin_block_bwd [{BATCH},{h},{h},{c}] heads={heads} "
              f"shift={shift}: kernel_ms={t_kernel:.4f} "
              f"plain_ms={t_plain:.4f} autograd_of_plain_fwd_bwd_ms="
              f"{t_autograd:.4f}\n  max_abs_err/max|ref| and 1-cos: "
              + ", ".join(report))
        ms += count * t_kernel
        plain_ms += count * t_plain
        autograd_ms += count * t_autograd
        fl, by = block_work(h, c, heads, shift, backward=True)
        flops += count * fl
        nbytes += count * by
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(max_abs_err=worst_abs, max_abs_err_rel=worst_rel, ms=ms,
                plain_ms=plain_ms, autograd_of_plain_ms=autograd_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def attention_work(h: int, c: int, heads: int, shift: int, backward: bool):
    """FLOPs and bytes one windowed attention at batch 16 needs.

    Forward, per token: 8 C^2 for the qkv and output projections and 256 C
    for the two 64-token attention products. The backward recomputes qkv and
    both attention products (6 C^2 + 256 C) and runs dwproj, d(merged),
    dwqkv, dx (16 C^2) and four more attention products per head (512 C).
    Bytes: x in and out (and dy in) in bf16, the parameters, the mask once;
    the backward also writes the f32 gradients.
    """
    tokens = BATCH * h * h
    per_token = (22 * c * c + 768 * c) if backward else (8 * c * c + 256 * c)
    params = 4 * c * c * 2 + 4 * c * 2 + heads * 4096 * 4
    extra = (h // 8) ** 2 * 4096 * 4 * (1 if shift else 0)
    acts = tokens * c * 2 * (3 if backward else 2)
    grads = (4 * c * c + 4 * c + heads * 4096) * 4 if backward else 0
    return tokens * per_token, acts + params + extra + grads


def check_window_attention(g: torch.Generator):
    """K3 against window_attention_reference and K4 against
    window_attention_backward_reference (dx and the five gradients) at the
    four geometries; times summed over the eight blocks of one forward or
    step."""
    k3 = dict(err=0.0, ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0,
              per_launch={}, call_per_launch={})
    k4 = dict(err=0.0, rel=0.0, ms=0.0, plain_ms=0.0, autograd_ms=0.0,
              flops=0.0, nbytes=0.0, per_launch={})
    for h, c, heads, shift, count in GEOMETRIES:
        args, mask, _ = block_inputs(h, c, heads, shift, g)
        x, wqkv, bqkv, wproj, bproj, rel_bias = args = args[:6]
        dy = torch.randn(x.shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        kw = dict(window_size=8, num_heads=heads)
        bwd_args = (x, wqkv, bqkv, wproj, rel_bias, mask, dy)
        with torch.no_grad():
            y = wa.window_attention(*args, mask, **kw)
            dx, grads = wa.window_attention_bwd(*bwd_args, **kw)
            torch.cuda.synchronize()
            ref = wa.window_attention_reference(*args, mask, **kw)
            rdx, rgrads = wa.window_attention_backward_reference(*bwd_args,
                                                                 **kw)
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        omc = one_minus_cos(y, ref)
        check(bool(torch.isfinite(y).all()), "K3 output finite")
        check(err <= K3_MAX_ABS_REL * scale,
              f"K3 max_abs_err {err} <= {K3_MAX_ABS_REL} * {scale}")
        check(omc <= K3_ONE_MINUS_COS, f"K3 1-cos {omc} <= {K3_ONE_MINUS_COS}")
        report = []
        for name, got, want in zip(("dx",) + wa.GRAD_NAMES, (dx,) + grads,
                                   (rdx,) + rgrads):
            check(bool(torch.isfinite(got).all()), f"K4 {name} finite")
            gerr = float((got.float() - want.float()).abs().max())
            gscale = float(want.float().abs().max())
            gomc = one_minus_cos(got, want)
            report.append(f"{name} {gerr / gscale:.2e}/{gomc:.1e}")
            check(gerr <= K4_MAX_ABS_REL * gscale,
                  f"K4 {name} max_abs_err {gerr} <= {K4_MAX_ABS_REL} * "
                  f"{gscale}")
            check(gomc <= K4_ONE_MINUS_COS,
                  f"K4 {name} 1-cos {gomc} <= {K4_ONE_MINUS_COS}")
            k4["err"] = max(k4["err"], gerr)
            k4["rel"] = max(k4["rel"], gerr / gscale)

        def autograd_of_plain():
            ins = [t.detach().requires_grad_(True) for t in args]
            out = wa.window_attention_reference(*ins, mask, **kw)
            return torch.autograd.grad(out, ins, dy)

        with torch.no_grad():
            t3 = kernel_ms(lambda: wa.window_attention(*args, mask, **kw),
                           iters=10)
            # with the wrapper's host work between launches, as a caller
            # that does not keep the card busy sees it
            t3_call = cuda_ms(lambda: wa.window_attention(*args, mask, **kw),
                              iters=10)
            t3_plain = kernel_ms(lambda: wa.window_attention_reference(
                *args, mask, **kw), iters=5)
            t4 = kernel_ms(lambda: wa.window_attention_bwd(*bwd_args, **kw),
                         iters=5)
            t4_plain = kernel_ms(
                lambda: wa.window_attention_backward_reference(*bwd_args,
                                                               **kw),
                iters=2)
        t4_autograd = kernel_ms(autograd_of_plain, iters=2)
        print(f"K3 window_attention [{BATCH},{h},{h},{c}] heads={heads} "
              f"shift={shift}: max_abs_err={err} (max|ref|={scale}) "
              f"1-cos={omc:.3e} kernel_ms={t3:.4f} (with the wrapper's host "
          f"work between launches {t3_call:.4f}) plain_ms={t3_plain:.4f}")
        print(f"K4 window_attention_bwd [{BATCH},{h},{h},{c}] heads={heads} "
              f"shift={shift}: kernel_ms={t4:.4f} plain_ms={t4_plain:.4f} "
              f"autograd_of_plain_fwd_bwd_ms={t4_autograd:.4f}\n"
              f"  max_abs_err/max|ref| and 1-cos: " + ", ".join(report))
        k3["err"] = max(k3["err"], err)
        k3["ms"] += count * t3
        key = f"{c}" + ("" if shift else " unshifted")
        k3["per_launch"][key] = t3
        k3["call_per_launch"][key] = t3_call
        k3["plain_ms"] += count * t3_plain
        k4["ms"] += count * t4
        k4["per_launch"][f"{c}" + ("" if shift else " unshifted")] = t4
        k4["plain_ms"] += count * t4_plain
        k4["autograd_ms"] += count * t4_autograd
        for k, backward in ((k3, False), (k4, True)):
            fl, by = attention_work(h, c, heads, shift, backward)
            k["flops"] += count * fl
            k["nbytes"] += count * by
    b3, by3 = bound(k3["flops"], k3["nbytes"])
    b4, by4 = bound(k4["flops"], k4["nbytes"])
    return (dict(max_abs_err=k3["err"], ms=k3["ms"], plain_ms=k3["plain_ms"],
                 bound_ms=b3, bound_by=by3, library_ms=None,
                 ms_per_launch=k3["per_launch"],
                 call_ms_per_launch=k3["call_per_launch"]),
            dict(max_abs_err=k4["err"], max_abs_err_rel=k4["rel"],
                 ms=k4["ms"], plain_ms=k4["plain_ms"],
                 autograd_of_plain_ms=k4["autograd_ms"], bound_ms=b4,
                 bound_by=by4, library_ms=None,
                 ms_per_launch=k4["per_launch"]))


def check_decoder_tail(g: torch.Generator) -> dict:
    """K7 against decoder_tail_reference at the flagship tail in bf16 and,
    at a small ragged shape, against the f32 composition of the same inputs.
    The reference is also the port's default tail (transposed conv, elu,
    conv through cuDNN): its time is what the kernel has to beat in the
    model. Times are of one launch."""
    def inputs(n, h, w, cin, cmid):
        def r(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale
        return (r(n, h, w, cin).to(torch.bfloat16),
                r(3, 3, cin, cmid, scale=(9 * cin) ** -0.5),
                r(cmid, scale=0.1),
                r(3, 3, cmid, 2, scale=(9 * cmid) ** -0.5), r(2, scale=0.1))

    def rnd(t):
        return t.to(torch.bfloat16).float()

    with torch.inference_mode():
        small = inputs(3, 20, 33, 96, 48)
        got = decoder_tail(*small)
        torch.cuda.synchronize()
        x, w_up, b_up, w_out, b_out = small
        ref32 = decoder_tail_reference(x.float(), w_up, b_up, rnd(w_out),
                                       rnd(b_out))
        err32 = float((got.float() - ref32).abs().max())
        scale32 = float(ref32.abs().max())
        omc32 = one_minus_cos(got, ref32)
        print(f"K7 decoder_tail [3,20,33,96] bf16 vs the f32 composition "
              f"(TF32 off): max_abs_err={err32} (max|ref|={scale32}) "
              f"1-cos={omc32:.3e}")
        check(err32 <= K7_MAX_ABS_REL * scale32,
              f"K7 vs f32: {err32} <= {K7_MAX_ABS_REL} * {scale32}")
        check(omc32 <= K7_ONE_MINUS_COS, f"K7 vs f32 1-cos {omc32}")

        # On the card the wrapper launches or raises: what neither route
        # takes never takes the naive composition. The flagship launch
        # below also shows that a refused launch leaves no error behind.
        before = decoder_tail.launches, decoder_tail.launches_any
        w4 = torch.zeros(3, 3, 48, 4, device="cuda")
        for what, bad in (
                ("four output channels", (x, w_up, b_up, w4, b_out)),
                ("an f16 input", (x.half(),) + small[1:]),
                ("a 3-D input", (x[0],) + small[1:])):
            try:
                decoder_tail(*bad)
            except (ValueError, RuntimeError) as e:
                print(f"K7 on {what} raises {type(e).__name__}: {e}")
            else:
                check(False, f"K7 on {what} must raise")
        check((decoder_tail.launches, decoder_tail.launches_any) == before,
              "the refused K7 calls launched nothing")

        # a tile owns 15 x 7 input pixels: one under, at and one over two
        # tiles a side, against the f32 composition; twice, bit-identical
        for eh, ew in ((29, 13), (30, 14), (31, 15)):
            edge = inputs(3, eh, ew, 96, 48)
            got = decoder_tail(*edge)
            again = decoder_tail(*edge)
            torch.cuda.synchronize()
            ref32 = decoder_tail_reference(edge[0].float(), edge[1], edge[2],
                                           rnd(edge[3]), rnd(edge[4]))
            err32 = float((got.float() - ref32).abs().max())
            scale32 = float(ref32.abs().max())
            print(f"K7 decoder_tail [3,{eh},{ew},96] vs the f32 composition: "
                  f"max_abs_err={err32} (max|ref|={scale32}); twice "
                  f"bit-identical: {torch.equal(got, again)}")
            check(err32 <= K7_MAX_ABS_REL * scale32,
                  f"K7 [3,{eh},{ew},96]: {err32} <= {K7_MAX_ABS_REL} * "
                  f"{scale32}")
            check(torch.equal(got, again),
                  f"K7 [3,{eh},{ew},96]: two runs bit-identical")

        n, h, cin, cmid = BATCH * 8, 128, 96, 48
        args = inputs(n, h, h, cin, cmid)
        y = decoder_tail(*args)
        check(torch.equal(y, decoder_tail(*args)),
              "K7: two runs bit-identical")
        torch.cuda.synchronize()
        ref = decoder_tail_reference(*args)
        check(tuple(y.shape) == (n, 2 * h, 2 * h, 2), f"K7 shape {y.shape}")
        check(bool(torch.isfinite(y).all()), "K7 output finite")
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        omc = one_minus_cos(y, ref)
        check(err <= K7_MAX_ABS_REL * scale,
              f"K7 max_abs_err {err} <= {K7_MAX_ABS_REL} * {scale}")
        check(omc <= K7_ONE_MINUS_COS, f"K7 1-cos {omc} <= {K7_ONE_MINUS_COS}")
        del ref
        t = [kernel_ms(fn, iters=5) for fn in (
            lambda: decoder_tail_reference(*args), lambda: decoder_tail(*args),
            lambda: decoder_tail(*args), lambda: decoder_tail_reference(*args))]
        t_phase = kernel_ms(lambda: decoder_tail_phase(*args), iters=5)
    ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    px = n * 4 * h * h  # upsampled pixels
    flops = 2.0 * px * (4 * cin) * cmid + 2.0 * px * 9 * cmid * 2
    nbytes = (n * h * h * cin + px * 2 + 9 * cin * cmid + 9 * cmid * 2) * 2
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"K7 decoder_tail [{n},{h},{h},{cin}] -> [{n},{2 * h},{2 * h},2]: "
          f"max_abs_err={err} (max|ref|={scale}) 1-cos={omc:.3e} "
          f"kernel_ms={ms:.4f} ({t[1]:.4f}, {t[2]:.4f}) "
          f"plain_ms={plain_ms:.4f} ({t[0]:.4f}, {t[3]:.4f}; the default "
          f"tail: transposed conv, elu, conv) phase_form_ms={t_phase:.4f} "
          f"bound_ms={bound_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                phase_form_ms=t_phase, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def check_warp_gather(g: torch.Generator):
    """K5 and K6 against their plain versions at the loss's shapes: S = 16
    samples x 8 waypoints, 256 x 256 queries at identity + a flow of a few
    pixels, some of them past the border. K6 also on a smooth flow (zero
    flow plus one fractional offset: the four queries around a pixel share
    it as a corner), on queries at the rows where its bands meet, and at
    other band counts."""
    s, h, w = BATCH * 8, 256, 256
    hp, wp, n = h + 2, w + 2, h * w
    dev = "cuda"
    img = torch.zeros(s, hp, wp, device=dev)
    img[:, 1:-1, 1:-1] = (torch.rand(s, h, w, generator=g, device=dev) < 0.1
                          ).float()
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    flow = torch.randn(s, h, w, 2, generator=g, device=dev) * 4.0
    x = (xs[None] + flow[..., 0] + 1.0).reshape(s, n)
    y = (ys[None] + flow[..., 1] + 1.0).reshape(s, n)
    outside = int(((x < 0) | (x > wp - 1) | (y < 0) | (y > hp - 1)).sum())
    check(outside > 0, "some queries fall past the border")
    x0f = torch.clamp(torch.floor(x), 0.0, wp - 2.0).contiguous()
    y0f = torch.clamp(torch.floor(y), 0.0, hp - 2.0).contiguous()
    gs = tuple(torch.randn(s, n, generator=g, device=dev) for _ in range(4))

    got = warp_gather_fwd(img, x0f, y0f)
    torch.cuda.synchronize()
    ref = gather_corners_reference(img, x0f, y0f)
    err5 = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    check(err5 <= K5_MAX_ABS, f"K5 max_abs_err {err5} <= {K5_MAX_ABS}")

    def check_scatter(what, qx, qy):
        dimg = warp_gather_bwd((s, hp, wp), qx, qy, gs)
        torch.cuda.synchronize()
        rdimg = scatter_corners_reference((s, hp, wp), qx, qy, gs)
        err = float((dimg - rdimg).abs().max())
        scale = float(rdimg.abs().max())
        print(f"K6 warp_gather_bwd, {what}: max_abs_err={err} "
              f"(max|ref|={scale})")
        check(err <= K6_MAX_ABS_REL * scale,
              f"K6 {what}: max_abs_err {err} <= {K6_MAX_ABS_REL} * {scale}")
        return err

    err6 = check_scatter("flow N(0, 4 px)", x0f, y0f)
    # the smooth flow: every pixel the corner of four neighbouring queries
    sx0 = (xs[None] + 1.0 + 0.3).floor().expand(s, h, w).reshape(s, n)
    sy0 = (ys[None] + 1.0 + 0.6).floor().expand(s, h, w).reshape(s, n)
    sx0, sy0 = sx0.contiguous(), sy0.contiguous()
    err6 = max(err6, check_scatter("smooth flow", sx0, sy0))
    # queries on the first and last rows and where two bands meet
    rows = bwd_band_rows(hp, wp)
    edge = torch.tensor(band_edge_rows(hp, rows), dtype=torch.float32,
                        device=dev)
    ey0 = edge.repeat(s * n // len(edge) + 1)[:s * n].reshape(s, n)
    ex0 = torch.randint(0, wp - 1, (s, n), generator=g, device=dev).float()
    err6 = max(err6, check_scatter(f"rows at band edges ({rows} rows a band)",
                                   ex0, ey0.contiguous()))

    # one PyTorch call on precomputed int64 indices, as the yardstick
    base = (y0f.long() * wp + x0f.long())
    idx4 = torch.cat([base + o for o in (0, 1, wp, wp + 1)], dim=1)
    flat = img.reshape(s, hp * wp)
    rows_off = (torch.arange(s, device=dev) * (hp * wp))[:, None]
    idx_flat = (idx4 + rows_off).reshape(-1)
    src = torch.cat(gs, dim=1).reshape(-1)
    acc = torch.zeros(s * hp * wp, device=dev)
    t5 = kernel_ms(lambda: warp_gather_fwd(img, x0f, y0f))
    t5_plain = kernel_ms(lambda: gather_corners_reference(img, x0f, y0f))
    t5_lib = kernel_ms(lambda: torch.gather(flat, 1, idx4))
    t6 = kernel_ms(lambda: warp_gather_bwd((s, hp, wp), x0f, y0f, gs))
    t6_smooth = kernel_ms(lambda: warp_gather_bwd((s, hp, wp), sx0, sy0, gs))
    t6_plain = kernel_ms(lambda: scatter_corners_reference((s, hp, wp), x0f,
                                                         y0f, gs))
    t6_lib = kernel_ms(lambda: acc.index_add_(0, idx_flat, src))
    by_bands = {str(k): kernel_ms(lambda: warp_gather_bwd(
        (s, hp, wp), x0f, y0f, gs, bands=k)) for k in (2, 3, 4, 6)}
    b5, by5 = bound(0.0, img.numel() * 4 + 2 * s * n * 4 + 4 * s * n * 4)
    b6, by6 = bound(0.0, 6 * s * n * 4 + img.numel() * 4)
    print(f"K5 warp_gather_fwd [{s},{hp},{wp}] x [{s},{n}] ({outside} "
          f"queries past the border): max_abs_err={err5} kernel_ms={t5:.4f} "
          f"plain_ms={t5_plain:.4f} torch.gather_ms={t5_lib:.4f} "
          f"bound_ms={b5:.4f}")
    print(f"K6 warp_gather_bwd: worst max_abs_err={err6} kernel_ms={t6:.4f} "
          f"(smooth flow {t6_smooth:.4f}; by bands of a slice: "
          + ", ".join(f"{k}: {v:.4f}" for k, v in by_bands.items())
          + f") plain_ms={t6_plain:.4f} index_add_ms={t6_lib:.4f} "
          f"bound_ms={b6:.4f}")
    return (dict(max_abs_err=err5, ms=t5, plain_ms=t5_plain, bound_ms=b5,
                 bound_by=by5, library_ms=t5_lib),
            dict(max_abs_err=err6, ms=t6, plain_ms=t6_plain, bound_ms=b6,
                 bound_by=by6, library_ms=t6_lib, smooth_flow_ms=t6_smooth,
                 ms_by_bands=by_bands, band_rows=rows,
                 smem_bytes=4 * rows * wp))


def general_work(kernel: str, b: int, h: int, c: int, heads: int, ws: int,
                 hidden: int, shift: int, es: int):
    """FLOPs and bytes of one call of the general route's K1-K4 at this
    geometry. Forward, per token: 8 C^2 for qkv and proj, 4 C hidden for the
    MLP (K1 only), 4 n C for the two attention products; a backward
    recomputes the forward and runs two products for each of its (3x).
    Bytes: the activations in and out (dy too) in the element type of ``es``
    bytes, the weights, rel-pos bias and mask once, the gradients in f32."""
    tokens, n = b * h * h, ws * ws
    mlp = 4 * c * hidden if kernel in ("k1", "k2") else 0
    flops = tokens * (8 * c * c + mlp + 4 * n * c)
    backward = kernel in ("k2", "k4")
    weights = 4 * c * c + (2 * c * hidden if kernel in ("k1", "k2") else 0)
    nbytes = (tokens * c * es * (3 if backward else 2) + weights * es
              + heads * n * n * 4
              + ((h // ws) ** 2 * n * n * 4 if shift else 0))
    if backward:
        flops *= 3
        nbytes += (weights + 8 * c + hidden + heads * n * n) * 4
    return flops, nbytes


def general_inputs(b, h, c, heads, ws, hidden, shift, dt, g):
    """Swin-block arguments at a general geometry: x and the matrix weights
    (and qkv's and proj's biases) in ``dt``, the rest f32."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    args = (r(b, h, h, c).to(dt),
            r(c, 3 * c, scale=c ** -0.5).to(dt), r(3 * c, scale=0.1).to(dt),
            r(c, c, scale=c ** -0.5).to(dt), r(c, scale=0.1).to(dt),
            r(heads, ws * ws, ws * ws, scale=0.3),
            1 + r(c, scale=0.1), r(c, scale=0.1),
            1 + r(c, scale=0.1), r(c, scale=0.1),
            r(c, hidden, scale=c ** -0.5).to(dt), r(hidden, scale=0.1),
            r(hidden, c, scale=hidden ** -0.5).to(dt), r(c, scale=0.1))
    mask = (torch.from_numpy(shifted_window_mask(h, h, ws, shift)).cuda()
            if shift else None)
    dp = torch.rand(b, 2, generator=g, device="cuda") * 1.2
    return args, mask, dp


def held_against(what: str, got, want, max_abs_rel: float,
                 omc_limit=None) -> float:
    """Checks ``got`` against the plain ``want``: max |got - want| within
    ``max_abs_rel`` of max |want| and, where given, 1 - cos within
    ``omc_limit``. Returns the error relative to max |want|."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    check(err <= max_abs_rel * scale,
          f"{what}: max_abs_err {err} <= {max_abs_rel} * {scale}")
    if omc_limit is not None:
        omc = one_minus_cos(got, want)
        check(omc <= omc_limit, f"{what}: 1-cos {omc} <= {omc_limit}")
    return err / scale if scale > 0 else err


def in_turns(plain_fn, kernel_fn, timer, rounds: int = TIMING_ROUNDS):
    """``(kernel, plain)``: ``spread`` of ``timer(fn)`` over ``rounds``
    rounds of plain / kernel / kernel / plain."""
    ks, ps = [], []
    for _ in range(rounds):
        ps.append(timer(plain_fn))
        ks += [timer(kernel_fn), timer(kernel_fn)]
        ps.append(timer(plain_fn))
    return spread(ks), spread(ps)


def fmt_spread(s: dict, digits: int = 4) -> str:
    return " / ".join(f"{s[k]:.{digits}f}" for k in ("min", "median", "max"))


def general_calls(args, mask, dp, dy, kw) -> dict:
    """{kernel: (general route, plain version)} of K1-K4 at these inputs;
    K2's and K4's plain versions round their operands to bf16, as both
    kernels do."""
    attn = args[:6]
    attn_bwd = (*attn[:4], attn[5], mask, dy)
    return {
        "k1": (lambda: swin_block(*args, mask, dp, **kw),
               lambda: swin_block_reference(*args, mask, dp, **kw)),
        "k2": (lambda: swin_block_bwd(*args, mask, dp, dy, **kw),
               lambda: swin_block_backward_reference(
                   *args, mask, dp, dy, operand_dtype=torch.bfloat16, **kw)),
        "k3": (lambda: wa.window_attention(*attn, mask, **kw),
               lambda: wa.window_attention_reference(*attn, mask, **kw)),
        "k4": (lambda: wa.window_attention_bwd(*attn_bwd, **kw),
               lambda: wa.window_attention_backward_reference(
                   *attn_bwd, operand_dtype=torch.bfloat16, **kw)),
    }


def general_limits(k: str, f32: bool):
    """(max |err| / max |ref|, 1 - cos or None) of the general K1-K4."""
    if f32 and k in ("k2", "k4"):
        return ANY_BF16_OPERANDS_MAX_ABS_REL, ANY_BF16_OPERANDS_ONE_MINUS_COS
    if f32:
        return ANY_F32_FWD_MAX_ABS_REL, None
    return {"k1": (K1_MAX_ABS_REL, K1_ONE_MINUS_COS),
            "k2": (K2_MAX_ABS_REL, K2_ONE_MINUS_COS),
            "k3": (K3_MAX_ABS_REL, K3_ONE_MINUS_COS),
            "k4": (K4_MAX_ABS_REL, K4_ONE_MINUS_COS)}[k]


def general_geometry(geo, g, names=("k1", "k2", "k3", "k4"), timed=True):
    """K1-K4 (those of ``names``) on the general route at ``geo``, each twice
    against its plain version: the limits, the two runs bit-identical, the
    kernels a call counted; timed beside the plain version in
    TIMING_ROUNDS rounds where ``timed``. Returns {kernel: dict(worst,
    worst_abs, per_call, ms, plain_ms, flops, bytes, bound_ms)} and prints
    one line."""
    b, h, c, heads, ws, hidden, shift, dtn = geo[:8]
    dt = getattr(torch, dtn)
    f32 = dt == torch.float32
    check(kernel_route(dt, c, heads, ws, hidden) == "any",
          f"[{b},{h},{h},{c}] heads {heads} ws {ws} {dtn} takes the "
          f"general route")
    args, mask, dp = general_inputs(b, h, c, heads, ws, hidden, shift, dt, g)
    dy = torch.randn(args[0].shape, generator=g, device="cuda").to(dt)
    kw = dict(window_size=ws, num_heads=heads)
    calls = general_calls(args, mask, dp, dy, kw)
    res = {}
    with torch.inference_mode():
        reset_counters()
        got, again, per_call, fwd_per_call = {}, {}, {}, {}
        for k in names:
            before = window_any_launches(), window_any_fwd_launches()
            got[k] = calls[k][0]()
            per_call[k] = window_any_launches() - before[0]
            fwd_per_call[k] = window_any_fwd_launches() - before[1]
            again[k] = calls[k][0]()
        torch.cuda.synchronize()
        check(read_general_counters() == counts(
                  GENERAL_COUNTERS, **{k: 2 for k in names})
              and read_counters() == counts(),
              f"two general launches of each of {names} and no other: "
              f"{read_general_counters()}, {read_counters()}")
        # every f32 product of a block's forward on fwd_product_kernel
        want_fwd = dict(k1=4, k2=3) if f32 else {}
        check(all(fwd_per_call[k] == want_fwd.get(k, 0) for k in names),
              f"fwd_product_kernel launches a call: {fwd_per_call} "
              f"(f32: K1 4, K2 3; else none)")
        want = {k: calls[k][1]() for k in names}
        line = []
        for k in names:
            limit, omc_limit = general_limits(k, f32)
            if k in ("k1", "k3"):
                pairs = [("y", got[k], want[k], again[k])]
            else:
                grad_names = GRAD_NAMES if k == "k2" else wa.GRAD_NAMES
                pairs = list(zip(("dx",) + grad_names,
                                 (got[k][0],) + tuple(got[k][1]),
                                 (want[k][0],) + tuple(want[k][1]),
                                 (again[k][0],) + tuple(again[k][1])))
            worst, worst_abs = 0.0, 0.0
            for name, a, w, a2 in pairs:
                what = f"{k} any [{b},{h},{h},{c}] ws {ws} {dtn} {name}"
                rel = held_against(what, a, w, limit, omc_limit)
                check(torch.equal(a, a2), f"{what}: two runs bit-identical")
                worst = max(worst, rel)
                worst_abs = max(worst_abs,
                                float((a.float() - w.float()).abs().max()))
            r = res[k] = dict(worst=worst, worst_abs=worst_abs,
                              per_call=per_call[k])
            text = (f"{k} err/max|ref|={worst:.2e} (limit {limit:.2e}"
                    + (f", 1-cos {omc_limit:.0e}" if omc_limit else "")
                    + f") kernels a call {per_call[k]} "
                    f"(fwd_product_kernel {fwd_per_call[k]})")
            if timed:
                ks, ps = in_turns(calls[k][1], calls[k][0],
                                  lambda fn: kernel_ms(fn, iters=3))
                fl, by = general_work(k, b, h, c, heads, ws, hidden, shift,
                                      2 if dt == torch.bfloat16 else 4)
                peak = PEAK_TF32X3_FLOPS if f32 else PEAK_BF16_FLOPS
                bms, bby = bound(fl, by, peak)
                bms_simt = bound(fl, by, PEAK_F32_FLOPS)[0] if f32 else bms
                r.update(ms=ks["median"], plain_ms=ps["median"],
                         flops=fl / peak, bytes=by / PEAK_HBM_BYTES,
                         bound_ms=bms)
                text += (f" ms={fmt_spread(ks)} plain_ms={fmt_spread(ps)} "
                         f"(min / median / max of {2 * TIMING_ROUNDS}) "
                         f"bound_ms={bms:.4f} ({bby}"
                         + (f"; f32 SIMT {bms_simt:.4f}" if f32 else "")
                         + ")")
            line.append(text)
        print(f"general route [{b},{h},{h},{c}] heads={heads} ws={ws} "
              f"hidden={hidden} shift={shift} {dtn}, 2 launches each, "
              f"bit-identical: " + "; ".join(line))
    del args, mask, dp, dy, got, again, want, calls
    torch.cuda.empty_cache()
    return res


def check_general_kernels(g: torch.Generator) -> dict:
    """The general route of K1-K4 at ANY_GEOMETRIES (``general_geometry``;
    K4 against a plain version with operands rounded to bf16, as it rounds
    them; in f32 within ANY_BF16_OPERANDS_*): the kernels of a call at most
    ANY_K1_MAX_KERNELS, ANY_K2_MAX_KERNELS, ANY_K3_MAX_KERNELS,
    ANY_K4_MAX_KERNELS, each timed beside its plain version (min / median / max printed per
    geometry, with f32's bound at the f32 SIMT rate beside the 3xTF32 one).
    Then ANY_EDGES, checked alike and not timed. Returns per kernel the
    worst error, the kernels a call, and the median times and the bounds
    (f32 at the 3xTF32 rate) summed over ANY_GEOMETRIES."""
    names = ("k1", "k2", "k3", "k4")
    most = dict(k1=ANY_K1_MAX_KERNELS, k2=ANY_K2_MAX_KERNELS,
                k3=ANY_K3_MAX_KERNELS, k4=ANY_K4_MAX_KERNELS)
    out = {k: dict(max_abs_err=0.0, max_abs_rel=0.0, ms=0.0, plain_ms=0.0,
                   flops=0.0, bytes=0.0, bound_ms=0.0,
                   kernels_per_call=0) for k in names}
    for geo in ANY_GEOMETRIES:
        res = general_geometry(geo, g)
        check(all(res[k]["per_call"] <= most[k] for k in names),
              "kernels a call: " + ", ".join(
                  f"{k.upper()} {res[k]['per_call']} (at most {most[k]})"
                  for k in names))
        for k in names:
            o, r = out[k], res[k]
            o["max_abs_err"] = max(o["max_abs_err"], r["worst_abs"])
            o["max_abs_rel"] = max(o["max_abs_rel"], r["worst"])
            o["kernels_per_call"] = max(o["kernels_per_call"],
                                        r["per_call"])
            for key in ("ms", "plain_ms", "bound_ms", "flops", "bytes"):
                o[key] += r[key]
    print("general route, kernels a call: "
          + ", ".join(f"{k.upper()} {out[k]['kernels_per_call']}"
                      for k in names))
    check_general_edges(g)
    check_attention_plans()
    for k in names:
        o = out[k]
        # the rate that sets the summed bound: the larger of the two sums
        o["bound_by"] = ("operations" if o.pop("flops") > o.pop("bytes")
                         else "bytes")
        o["library_ms"] = None
    return out


def check_general_edges(g: torch.Generator) -> None:
    """ANY_EDGES: K3 at its largest widths and K2 in f32 at head_dim 64 and
    256 tokens (its route printed), each twice against its plain version,
    with its kernels a call held to ANY_K3_MAX_KERNELS or
    ANY_K2_MAX_KERNELS."""
    for geo in ANY_EDGES:
        b, h, c, heads, ws, hidden, shift, dtn, what = geo
        k = what[:2]
        most = ANY_K3_MAX_KERNELS if k == "k3" else ANY_K2_MAX_KERNELS
        res = general_geometry(geo, g, (k,), timed=False)
        route = kernel_route(getattr(torch, dtn), c, heads, ws, hidden)
        print(f"  edge {what}: route {route}, {res[k]['per_call']} kernels "
              f"a call (at most {most})")
        check(res[k]["per_call"] <= most, f"{what}: kernels a call")


def check_attention_plans() -> None:
    """The grid of the general route's forward attention as the library
    computes it (``attn_plan``) against its Python twin
    (``ops/window_attention.py::attention_plan``) at every geometry of
    ANY_GEOMETRIES and ANY_EDGES."""
    plans = []
    for geo in ANY_GEOMETRIES + ANY_EDGES:
        b, h, c, heads, ws = geo[:5]
        got = wa.attention_plan_of_kernel(b, h, h, c, heads, ws)
        want = wa.attention_plan(ws * ws, heads, b * (h // ws) ** 2)
        check(got == want, f"attention plan at [{b},{h},{h},{c}] heads "
              f"{heads} ws {ws}: library {got}, Python {want}")
        plans.append(f"[{b},{h},{h},{c}] ws {ws}: {got[0]} x {got[1]}")
    print("general attention plans (strips a block x parts of the keys), "
          "library = Python: " + "; ".join(plans))


# (B, H = W, C, heads, window, MLP width, shift, dtype) where the general K1,
# K2, K3 and K4 are broken down by kernel: the flagship's last width in f32,
# the Swin-B width in bf16; K3 and K4 also at windows of 256 tokens in bf16.
# K7 at the f32 flagship tail (ANY_TAILS[2]).
ANY_BREAKDOWN = ((2, 32, 384, 12, 8, 1536, 4, "float32"),
                 (2, 128, 128, 4, 8, 512, 4, "bfloat16"))
ANY_BREAKDOWN_K4 = ANY_BREAKDOWN + ((1, 32, 64, 2, 16, 256, 8, "bfloat16"),)


def device_us_by_kernel(fn, names, calls: int = 3) -> str:
    """Device time of one call of ``fn`` by kernel (``torch.profiler`` over
    ``calls`` calls), the kernels named by the first of ``names`` their
    names hold, largest first."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((n for n in names if n in e.name), "other")
            us[name] = us.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return ", ".join(f"{n} {t:.1f}" for n, t in sorted(
        us.items(), key=lambda kv: -kv[1]))


def addmm_us(args) -> float:
    """Device us of ``torch.addmm`` on the general K3's two products at
    these block arguments, in their type (TF32 off in f32): qkv = x @ wqkv
    + bqkv and proj = merged @ wproj + bproj over all tokens (merged a
    random stand-in of its shape). A yardstick for the kernels' product
    stage, not a route of the port."""
    x, wqkv, bqkv, wproj, bproj = args[:5]
    x2 = x.reshape(-1, x.shape[-1])
    merged = torch.randn_like(x2)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            return 1e3 * kernel_ms(lambda: (torch.addmm(bqkv, x2, wqkv),
                                            torch.addmm(bproj, merged, wproj)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def general_breakdown(g: torch.Generator) -> None:
    """Device time of the general K1, K2, K3 and K4 by kernel at
    ANY_BREAKDOWN (K3 and K4 at ANY_BREAKDOWN_K4; K3 with the time of
    ``torch.addmm`` on its two products beside, ``addmm_us``) and of the
    general K7 at the f32 flagship tail: where a call's time goes."""
    for geo in ANY_BREAKDOWN_K4:
        b, h, c, heads, ws, hidden, shift, dtn = geo
        dt = getattr(torch, dtn)
        args, mask, dp = general_inputs(b, h, c, heads, ws, hidden, shift,
                                        dt, g)
        dy = torch.randn(args[0].shape, generator=g, device="cuda").to(dt)
        kw = dict(window_size=ws, num_heads=heads)
        attn_bwd = (*args[:4], args[5], mask, dy)
        calls = (("K1", lambda: swin_block(*args, mask, dp, **kw)),
                 ("K2", lambda: swin_block_bwd(*args, mask, dp, dy, **kw)),
                 ("K3", lambda: wa.window_attention(*args[:6], mask, **kw)),
                 ("K4", lambda: wa.window_attention_bwd(*attn_bwd, **kw)))
        for k, fn in calls:
            if k in ("K1", "K2") and geo not in ANY_BREAKDOWN:
                continue
            print(f"general {k} [{b},{h},{h},{c}] ws {ws} {dtn}, device us "
                  f"a call by kernel: "
                  + device_us_by_kernel(fn, WINDOW_ANY_KERNELS)
                  + (f"; torch.addmm of its two products {addmm_us(args):.1f}"
                     if k == "K3" else ""))
        del args, mask, dp, dy
    n, h, cin, cmid, dtn = ANY_TAILS[2]
    dt = getattr(torch, dtn)
    args = tail_inputs(n, h, cin, cmid, dt, g)
    print(f"general K7 [{n},{h},{h},{cin}] -> {cmid} {dtn}, device us a "
          f"call by kernel: "
          + device_us_by_kernel(lambda: decoder_tail(*args),
                                DECODER_TAIL_ANY_KERNELS))
    del args


WINDOW_ANY_KERNELS = ("fwd_product_kernel", "gemm_kernel", "gemm_sm90_kernel",
                      "gemm_tf32x3_kernel", "atb_kernel", "attn_fwd_kernel",
                      "attn_bwd_kernel", "ln_bwd_kernel", "reduce_kernel",
                      "qk_norm_kernel", "qk_norm_bwd_kernel",
                      "swinv2_attn_kernel",
                      "postnorm_kernel", "postnorm_bwd_kernel",
                      "add_rows_kernel")
DECODER_TAIL_ANY_KERNELS = ("fold_tail_weights_kernel",
                            "decoder_tail_any_kernel")


def window_any_label(name: str, kernels=WINDOW_ANY_KERNELS) -> str:
    """A general-route kernel's mangled name (``csrc/window_any.cu`` or, with
    ``kernels``, another source's), shortened to the kernel, its element type
    and its template flags."""
    base = next((k for k in kernels if k in name), name)
    rest = name.split(base, 1)[1]
    kind = ("bf16" if "nv_bfloat16" in rest
            else "f32" if rest.startswith("If") else "")
    parts = [kind] if kind else []
    parts += re.findall(r"L[bi](\d+)E", rest)
    return base + (f"<{','.join(parts)}>" if parts else "")


def tail_inputs(n, h, cin, cmid, dt, g):
    """The tail's arguments at [n, h, h, cin] -> cmid: x in ``dt``, the
    weights f32."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return (r(n, h, h, cin).to(dt), r(3, 3, cin, cmid,
                                      scale=(9 * cin) ** -0.5),
            r(cmid, scale=0.1), r(3, 3, cmid, 2, scale=(9 * cmid) ** -0.5),
            r(2, scale=0.1))


def check_general_tail(g: torch.Generator) -> dict:
    """The general K7 at ANY_TAILS against the naive composition in the same
    element type (f32 with TF32 off), twice (bit-identical), timed beside it
    in TIMING_ROUNDS rounds (min / median / max); f32's bound at the 3xTF32
    rate. Returns the worst error, the median times and bounds summed over
    the tails, and the sums over the first ANY_TAILS_BEFORE tails."""
    res = dict(max_abs_err=0.0, max_abs_rel=0.0, ms=0.0, plain_ms=0.0,
               bound_ms=0.0, ms_tails_before=0.0, plain_ms_tails_before=0.0,
               library_ms=None)
    secs = dict(flops=0.0, bytes=0.0)
    for i, (n, h, cin, cmid, dtn) in enumerate(ANY_TAILS):
        dt = getattr(torch, dtn)
        check(dtl.kernel_route(dt, cin, cmid, 2) == "any",
              f"K7 {cin} -> {cmid} {dtn} takes the general route")
        args = tail_inputs(n, h, cin, cmid, dt, g)
        with torch.inference_mode():
            reset_counters()
            y = decoder_tail(*args)
            again = decoder_tail(*args)
            torch.cuda.synchronize()
            check(read_general_counters() == counts(GENERAL_COUNTERS, k7=2)
                  and read_counters() == counts(),
                  f"two general K7 launches and no other: "
                  f"{read_general_counters()}, {read_counters()}")
            ref = decoder_tail_reference(*args)
            check(tuple(y.shape) == (n, 2 * h, 2 * h, 2) and y.dtype == dt,
                  f"K7 any shape {tuple(y.shape)} {y.dtype}")
            f32 = dt == torch.float32
            limit = ANY_F32_FWD_MAX_ABS_REL if f32 else K7_MAX_ABS_REL
            omc_limit = None if f32 else K7_ONE_MINUS_COS
            what = f"K7 any [{n},{h},{h},{cin}] -> {cmid} {dtn}"
            rel = held_against(what, y, ref, limit, omc_limit)
            check(torch.equal(y, again), f"{what}: two runs bit-identical")
            err = float((y.float() - ref.float()).abs().max())
            ks, ps = in_turns(lambda: decoder_tail_reference(*args),
                              lambda: decoder_tail(*args),
                              lambda fn: kernel_ms(fn, iters=3))
        ms, plain_ms = ks["median"], ps["median"]
        px, es = n * 4 * h * h, 4 if f32 else 2
        # the phase form's 4 taps an upsampled pixel for the
        # up-convolution, the output convolution's 9 taps at the least
        flops = 2.0 * px * 4 * cin * cmid + 2.0 * px * 9 * cmid * 2
        nbytes = (n * h * h * cin + px * 2) * es + (9 * cin * cmid
                                                    + 9 * cmid * 2) * 4
        peak = PEAK_TF32X3_FLOPS if f32 else PEAK_BF16_FLOPS
        bms, bby = bound(flops, nbytes, peak)
        print(f"general K7 [{n},{h},{h},{cin}] -> {cmid} -> 2 {dtn}, 2 "
              f"calls, bit-identical: err/max|ref|={rel:.2e} (limit "
              f"{limit:.2e}" + (f", 1-cos {omc_limit:.0e}" if omc_limit
                                else "")
              + f") ms={fmt_spread(ks)} plain_ms={fmt_spread(ps)} (min / "
              f"median / max of {2 * TIMING_ROUNDS}) bound_ms={bms:.4f} "
              f"({bby}" + ("; f32 SIMT "
                           f"{bound(flops, nbytes, PEAK_F32_FLOPS)[0]:.4f}"
                           if f32 else "") + ")")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["max_abs_rel"] = max(res["max_abs_rel"], rel)
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["bound_ms"] += bms
        secs["flops"] += flops / peak
        secs["bytes"] += nbytes / PEAK_HBM_BYTES
        if i < ANY_TAILS_BEFORE:
            res["ms_tails_before"] += ms
            res["plain_ms_tails_before"] += plain_ms
        del args, y, again, ref
    res["bound_by"] = ("operations" if secs["flops"] > secs["bytes"]
                       else "bytes")
    print(f"general K7, medians summed: the first {ANY_TAILS_BEFORE} tails "
          f"{res['ms_tails_before']:.4f} ms (plain "
          f"{res['plain_ms_tails_before']:.4f}), all {len(ANY_TAILS)} "
          f"{res['ms']:.4f} ms (plain {res['plain_ms']:.4f}), bound "
          f"{res['bound_ms']:.4f} ms")
    return res


def v2_inputs(h: int, c: int, heads: int, shift: int, g: torch.Generator,
              batch: int = BATCH):
    """SwinV2 block arguments at window 16 and MLP width 4C, drawn as the
    kernel tests draw them: x and the matrix weights (and qkv's and proj's
    biases, k's third zero) in bf16; a bias of 16 sigmoid(z); logit scales
    spread over ln 10 +- 1.5, head 0's past the clamp; the rest f32."""
    n, hidden, bf = 256, 4 * c, torch.bfloat16

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    tau = math.log(10.0) + 1.5 * (torch.rand(heads, generator=g,
                                             device="cuda")
                            * 2 - 1)
    tau[0] = 5.0
    bqkv = r(3 * c, scale=0.1)
    bqkv[c:2 * c] = 0.0
    args = (r(batch, h, h, c).to(bf), r(c, 3 * c, scale=c ** -0.5).to(bf),
            bqkv.to(bf), r(c, c, scale=c ** -0.5).to(bf),
            r(c, scale=0.1).to(bf), 16.0 * torch.sigmoid(r(heads, n, n)),
            tau, 1 + r(c, scale=0.2), r(c, scale=0.1), 1 + r(c, scale=0.2),
            r(c, scale=0.1), r(c, hidden, scale=c ** -0.5).to(bf),
            r(hidden, scale=0.1), r(hidden, c, scale=hidden ** -0.5).to(bf),
            r(c, scale=0.1))
    mask = (torch.from_numpy(shifted_window_mask(h, h, 16, shift)).cuda()
            if shift else None)
    dp = torch.rand(batch, 2, generator=g, device="cuda") * 1.2
    return args, mask, dp


def v2_held(what: str, got, plain, exact, dtau: bool = False) -> float:
    """The SwinV2 route's ``got`` against the plain block in f32
    (``exact``): within V2_BF16_FACTOR times the plain bf16 block's
    (``plain``) distance, with the floors; dtau at V2_DTAU_*. Returns the
    largest entry's error over the largest entry of ``exact``."""
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    scale = float(exact.float().abs().max())

    def gaps(t):
        return (float((t.float() - exact.float()).abs().max()) / scale,
                one_minus_cos(t, exact))

    err, omc = gaps(got)
    if dtau:
        lim = (V2_DTAU_MAX_ABS_REL, V2_DTAU_ONE_MINUS_COS)
    else:
        perr, pomc = gaps(plain)
        lim = (max(V2_BF16_FACTOR * perr, V2_BF16_FLOOR),
               max(V2_BF16_FACTOR * pomc, V2_BF16_COS_FLOOR))
    check(err <= lim[0] and omc <= lim[1],
          f"{what}: err/max|f32| {err:.3e} <= {lim[0]:.3e} and 1-cos "
          f"{omc:.3e} <= {lim[1]:.3e}")
    return err


def v2_call(fn, counter, want: int, what: str):
    """``fn()`` with ``counter.launches_any`` zeroed just before: one call
    counted there and ``want`` kernels in the library's own count."""
    counter.launches_any = 0
    before = window_any_launches()
    out = fn()
    torch.cuda.synchronize()
    kernels = window_any_launches() - before
    check(counter.launches_any == 1 and kernels == want,
          f"{what}: {counter.launches_any} call(s) and {kernels} kernels "
          f"(want 1 and {want})")
    return out


def as_f32(args):
    return [t.float() if t.dtype == torch.bfloat16 else t for t in args]


def v2_stage_work(h: int, c: int, heads: int, shift: int, save: bool):
    """FLOPs and bytes of the SwinV2 attention stage at batch 16 and window
    16: q k^T and p @ v, 4 n hd flops a query and head; q, k, v read and
    merged written in bf16, rel and the mask (where shifted) read once in
    f32; with ``save`` raw q, k and q', k' written (bf16) and the row
    statistics (f32 pairs)."""
    n, hd, tokens = 256, c // heads, BATCH * h * h
    flops = 4 * tokens * heads * n * hd
    nbytes = (4 * tokens * c * 2 + heads * n * n * 4
              + (h // 16) ** 2 * n * n * 4 * bool(shift))
    if save:
        nbytes += 4 * tokens * c * 2 + tokens * heads * 8
    return flops, nbytes


def check_swinv2_attention_stage(g: torch.Generator) -> dict:
    """The SwinV2 block's attention stage alone at V2_GEOMETRIES, shifted
    and not: the fused kernel (``swinv2_attn_kernel``) against the two
    launches it replaced (``qk_norm_kernel``, ``attn_fwd_kernel``) on the
    same bf16 qkv, with the backward's saves: q', k' and raw q, k bit for
    bit, merged and the row statistics held against the plain stage in f32
    as ``v2_held`` holds a block (within twice the two launches' distance).
    Device times in turns (two launches, fused, fused, two launches), the
    forward's and the recompute's; bounds by bytes and by operations.
    Returns the sums over a pass of the 26 blocks (half of them shifted)."""
    total = dict(fused_ms=0.0, two_launch_ms=0.0, fused_save_ms=0.0,
                 two_launch_save_ms=0.0, bound_ms=0.0, bound_save_ms=0.0)
    for h, c, heads, shift0, count in V2_GEOMETRIES:
        for shift in sorted({0, shift0}):
            n = 256
            qkv = torch.randn(BATCH * h * h, 3 * c, generator=g,
                              device="cuda").to(torch.bfloat16)
            tau = math.log(10.0) + 1.5 * (torch.rand(
                heads, generator=g, device="cuda") * 2 - 1)
            tau[0] = 5.0
            rel = 16.0 * torch.sigmoid(torch.randn(heads, n, n, generator=g,
                                                   device="cuda"))
            mask = (torch.from_numpy(shifted_window_mask(h, h, 16, shift))
                    .cuda() if shift else None)
            kw = dict(window_size=16, num_heads=heads)
            geo = dict(batch=BATCH, height=h, width=h, **kw)
            what = (f"SwinV2 attention stage [{BATCH},{h},{h},{c}] "
                    f"shift={shift}")
            check(v2.fused_attention(qkv.dtype, c // heads),
                  f"{what}: the route fuses the stage")
            fq, tq = qkv.clone(), qkv.clone()
            fused = v2.attention_stage(fq, tau, rel, mask, fused=True,
                                       save=True, **geo)
            two = v2.attention_stage(tq, tau, rel, mask, fused=False,
                                     save=True, **geo)
            torch.cuda.synchronize()
            check(torch.equal(fq, tq) and torch.equal(fused[1], two[1]),
                  f"{what}: q', k' and raw q, k bit for bit")
            exact = v2.attention_stage_reference(qkv.float(), tau, rel, mask,
                                                 **kw)
            errs = [v2_held(f"{what} {name}", a, b, e) for name, a, b, e in (
                ("merged", fused[0], two[0], exact[1]),
                ("max", fused[2][..., 0], two[2][..., 0], exact[3][..., 0]),
                ("sum", fused[2][..., 1], two[2][..., 1], exact[3][..., 1]))]
            del fused, two, exact, fq, tq
            times = {}
            for name, fz in (("two", False), ("fused", True), ("fused", True),
                             ("two", False)):
                for save in (False, True):
                    x = qkv.clone()
                    times.setdefault((name, save), []).append(kernel_ms(
                        lambda: v2.attention_stage(x, tau, rel, mask,
                                                   fused=fz, save=save,
                                                   **geo), iters=10))
            ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
            b0, by0 = bound(*v2_stage_work(h, c, heads, shift, False))
            b1, _ = bound(*v2_stage_work(h, c, heads, shift, True))
            print(f"{what}: err/max|f32| merged {errs[0]:.3e} max "
                  f"{errs[1]:.3e} sum {errs[2]:.3e}; kernel_ms fused "
                  f"{ms[('fused', False)]:.4f} (save "
                  f"{ms[('fused', True)]:.4f}), two launches "
                  f"{ms[('two', False)]:.4f} ({ms[('two', True)]:.4f}); "
                  f"bound {b0:.4f} ms by {by0} ({b1:.4f} with the saves): "
                  f"{100 * b0 / ms[('fused', False)]:.1f} % "
                  f"({100 * b1 / ms[('fused', True)]:.1f} %)")
            share = count / 2 if shift0 else count   # half the blocks shift
            total["fused_ms"] += share * ms[("fused", False)]
            total["two_launch_ms"] += share * ms[("two", False)]
            total["fused_save_ms"] += share * ms[("fused", True)]
            total["two_launch_save_ms"] += share * ms[("two", True)]
            total["bound_ms"] += share * b0
            total["bound_save_ms"] += share * b1
            del qkv, rel, mask
            torch.cuda.empty_cache()
    print("SwinV2 attention stage over a pass of the 26 blocks: "
          + ", ".join(f"{k} {v:.3f}" for k, v in total.items()))
    return total


def check_swinv2_block(g: torch.Generator) -> dict:
    """The SwinV2 block's forward kernels (``swinv2_any_fwd``) against the
    plain block at V2_GEOMETRIES (``v2_held``), FWD_LAUNCHES kernels a call;
    times and bounds summed over the 26 blocks of a forward, each
    geometry's times its count; the kernels' device time by kernel at C
    128."""
    worst, ms, plain_ms, flops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0
    for h, c, heads, shift, count in V2_GEOMETRIES:
        args, mask, dp = v2_inputs(h, c, heads, shift, g)
        kw = dict(window_size=16, num_heads=heads)
        what = f"SwinV2 forward [{BATCH},{h},{h},{c}] heads {heads}"
        with torch.inference_mode():
            y = v2_call(lambda: v2.swinv2_block(*args, mask, dp, **kw),
                        v2.swinv2_block, v2.FWD_LAUNCHES, what)
            plain = v2.swinv2_block_reference(*args, mask, dp, **kw)
            exact = v2.swinv2_block_reference(*as_f32(args), mask, dp, **kw)
            err = v2_held(what, y, plain, exact)
            del plain, exact
            t_kernel = kernel_ms(lambda: v2.swinv2_block(*args, mask, dp,
                                                         **kw), iters=10)
            t_plain = kernel_ms(lambda: v2.swinv2_block_reference(
                *args, mask, dp, **kw), iters=5)
        print(f"{what} shift={shift}: err/max|f32|={err:.3e} "
              f"kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f}")
        if c == 128:
            print("  device us a call by kernel: " + device_us_by_kernel(
                lambda: v2.swinv2_block(*args, mask, dp, **kw),
                WINDOW_ANY_KERNELS))
        worst = max(worst, err)
        ms += count * t_kernel
        plain_ms += count * t_plain
        fl, by = general_work("k1", BATCH, h, c, heads, 16, 4 * c, shift, 2)
        flops += count * fl
        nbytes += count * by
        del args, mask, dp, y
        torch.cuda.empty_cache()
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(max_abs_err_rel=worst, kernels_per_call=v2.FWD_LAUNCHES,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_swinv2_block_bwd(g: torch.Generator) -> dict:
    """The SwinV2 block's backward kernels (``swinv2_any_bwd``: the forward
    recomputed, dx and the 14 gradients) against autograd of the plain block
    at V2_GEOMETRIES (``v2_held``; dbqkv without k's third, no gradient;
    dtau zero for the head past the clamp and no other), BWD_LAUNCHES
    kernels a call; times summed over the 26 blocks of a step, the plain
    time that of autograd's forward and backward; the kernels' device time
    by kernel at C 128."""
    worst, ms, plain_ms, flops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0
    for h, c, heads, shift, count in V2_GEOMETRIES:
        args, mask, dp = v2_inputs(h, c, heads, shift, g)
        dy = torch.randn(args[0].shape, generator=g,
                         device="cuda").to(torch.bfloat16)
        kw = dict(window_size=16, num_heads=heads)
        what = f"SwinV2 backward [{BATCH},{h},{h},{c}] heads {heads}"

        def autograd_of_plain(ins, d):
            ins = [t.detach().requires_grad_(True) for t in ins]
            y = v2.swinv2_block_reference(*ins, mask, dp, **kw)
            return torch.autograd.grad(y, ins, d)

        with torch.no_grad():
            dx, grads = v2_call(
                lambda: v2.swinv2_block_bwd(*args, mask, dp, dy, **kw),
                v2.swinv2_block_bwd, v2.BWD_LAUNCHES, what)
        plain = autograd_of_plain(args, dy)
        exact = autograd_of_plain(as_f32(args), dy.float())
        report = []
        for name, got, p, e in zip(("dx",) + v2.GRAD_NAMES,
                                   (dx,) + grads, plain, exact):
            if name == "dbqkv":
                got, p, e = (torch.cat([t[:c], t[2 * c:]])
                             for t in (got, p, e))
            err = v2_held(f"{what} {name}", got, p, e, name == "dtau")
            report.append(f"{name} {err:.2e}")
            if name != "dtau":
                worst = max(worst, err)
        dtau = grads[v2.GRAD_NAMES.index("dtau")]
        check(float(dtau[0]) == 0.0 and float(dtau[1:].abs().min()) > 0.0,
              f"{what}: dtau zero past the clamp (head 0) and no other")
        del plain, exact
        with torch.no_grad():
            t_kernel = kernel_ms(lambda: v2.swinv2_block_bwd(
                *args, mask, dp, dy, **kw), iters=5)
        t_plain = kernel_ms(lambda: autograd_of_plain(args, dy), iters=2)
        print(f"{what} shift={shift}: kernel_ms={t_kernel:.4f} "
              f"autograd_of_plain_fwd_bwd_ms={t_plain:.4f}\n  err/max|f32|: "
              + ", ".join(report))
        if c == 128:
            print("  device us a call by kernel: " + device_us_by_kernel(
                lambda: v2.swinv2_block_bwd(*args, mask, dp, dy, **kw),
                WINDOW_ANY_KERNELS))
        ms += count * t_kernel
        plain_ms += count * t_plain
        fl, by = general_work("k2", BATCH, h, c, heads, 16, 4 * c, shift, 2)
        flops += count * fl
        nbytes += count * by
        del args, mask, dp, dy, dx, grads
        torch.cuda.empty_cache()
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(max_abs_err_rel=worst, kernels_per_call=v2.BWD_LAUNCHES,
                ms=ms, autograd_of_plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def to_device(batch, keys=MODEL_KEYS):
    return {k: torch.from_numpy(batch[k]).cuda() for k in keys}


def forward(model, b):
    return model(ogm=b["ogm"], map_img=b["map_image"], obs=b["actors"],
                 occ=b["occl_actors"], mapt=b["centerlines"],
                 flow=b["vec_flow"])


def counts(counters=COUNTERS, **launches):
    """A reading of ``counters`` (the wgmma route's K1-K7 by default, or
    GENERAL_COUNTERS) with the named kernels' launches and 0 elsewhere."""
    unknown = set(launches) - set(counters)
    if unknown:
        raise KeyError(f"no such counters: {unknown}")
    return tuple(launches.get(k, 0) for k in counters)


def check_forward(state):
    """The flagship forward through K1 against the plain path."""
    cfg = STRAJNET_CONFIG
    model = STrajNet(cfg)
    model.load_state_dict(state)
    model = model.cuda().eval()
    plain = STrajNet(dataclasses.replace(cfg, use_pallas_attention=False))
    plain.load_state_dict(state)
    plain = plain.cuda().eval()
    batch = to_device(synthetic_batch(cfg, BATCH, seed=0))
    oh, ow = cfg.output_size
    with torch.inference_mode():
        reset_counters()
        y = forward(model, batch)
        torch.cuda.synchronize()
        per_forward = read_counters()
        y_plain = forward(plain, batch)
        check(per_forward == counts(k1=8), f"8 K1 launches per forward and "
                                           f"no other, got {per_forward}")
        check(read_general_counters() == counts(GENERAL_COUNTERS),
              f"the flagship forward takes the wgmma route only, got "
              f"{read_general_counters()} general launches")
        check(tuple(y.shape) == (BATCH, oh, ow, 4 * cfg.num_waypoints),
              f"forward shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "forward output finite")
        omc = one_minus_cos(y, y_plain)
        err = float((y - y_plain).abs().max())
        print(f"forward [{BATCH},{oh},{ow},{4 * cfg.num_waypoints}] kernel "
              f"vs plain: 1-cos={omc:.3e} max_abs_err={err} "
              f"(max|plain|={float(y_plain.abs().max())})")
        check(omc <= FWD_ONE_MINUS_COS,
              f"forward 1-cos {omc} <= {FWD_ONE_MINUS_COS}")

        # plain, kernel, kernel, plain on the same card
        t = [cuda_ms(lambda: forward(m, batch), iters=3)
             for m in (plain, model, model, plain)]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        print(f"forward batch {BATCH} bf16: kernel path {ms:.3f} ms "
              f"({t[1]:.3f}, {t[2]:.3f}); plain path {plain_ms:.3f} ms "
              f"({t[0]:.3f}, {t[3]:.3f}); {BATCH / ms * 1e3:.1f} scenes/s "
              f"through the kernel")

        # bf16 kernel path vs an f32 plain forward, on 2 samples
        ref_cfg = dataclasses.replace(cfg, dtype="float32",
                                      use_pallas_attention=False)
        ref = STrajNet(ref_cfg)
        ref.load_state_dict(state)
        ref = ref.cuda().eval()
        small = {k: v[:2] for k, v in batch.items()}
        omc32 = one_minus_cos(forward(model, small), forward(ref, small))
        print(f"forward bf16 kernel path vs f32 plain path (batch 2): "
              f"1-cos={omc32:.3e}")
        check(omc32 <= F32_ONE_MINUS_COS,
              f"bf16 vs f32 1-cos {omc32} <= {F32_ONE_MINUS_COS}")
    return model


def serve(model) -> int:
    """Three batches of 16 through run_shard; parses the submission back."""
    cfg = STRAJNET_CONFIG
    batches = []
    for i in range(3):
        b = synthetic_batch(cfg, BATCH, seed=100 + i)
        b = {k: b[k] for k in MODEL_KEYS}
        b["scenario/id"] = np.array([f"synthetic-{i}-{j:02d}"
                                     for j in range(BATCH)])
        batches.append(b)
    ids = {s for b in batches for s in b["scenario/id"]}
    with tempfile.TemporaryDirectory() as out_dir:
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = run_shard(model, make_predict_step(cfg.num_waypoints),
                          "00000new.tfrecords", ids, out_dir,
                          batch_size=BATCH, batches=batches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
        name = "occupancy_flow_submission.binproto-00000-of-00150"
        with open(os.path.join(out_dir, name), "rb") as f:
            buf = f.read()
    scenarios = [v for fn, _, v in iter_fields(buf)
                 if fn == SUBMISSION_SCENARIO_PREDICTIONS]
    parsed_ids = set()
    for sc in scenarios:
        fields = list(iter_fields(sc))
        parsed_ids.update(v.decode() for fn, _, v in fields
                          if fn == SCENARIO_ID)
        n_wp = sum(1 for fn, _, _ in fields if fn == SCENARIO_WAYPOINTS)
        check(n_wp == cfg.num_waypoints, f"{n_wp} waypoints in a scenario")
    print(f"run_shard: {count} scenarios in {seconds:.3f} s "
          f"({count / seconds:.2f} scenes/s end to end, host quantization "
          f"and writing included); {len(scenarios)} parsed back; "
          f"{launches[0]} K1 launches")
    check(count == 3 * BATCH and len(scenarios) == 3 * BATCH,
          f"48 scenarios written and parsed, got {count}/{len(scenarios)}")
    check(parsed_ids == ids, "parsed scenario ids match")
    check(launches == counts(k1=3 * 8),
          f"24 K1 launches on the served path and no other, got {launches}")
    return launches


def warp_gradient_path():
    """``core.sampling.flow_warp_origin`` differentiated with respect to the
    warped image, the one caller that reaches K6 (the loss warps ground
    truth, which needs no gradient). Held against the portable path
    ``core.sampling.sample`` under autograd. Returns the counters."""
    g = torch.Generator(device="cuda").manual_seed(1)
    s, h, w = BATCH * 8, 256, 256
    origin = torch.rand(s, h, w, 1, generator=g, device="cuda")
    flow = torch.randn(s, h, w, 2, generator=g, device="cuda") * 4.0
    weight = torch.randn(s, h, w, 1, generator=g, device="cuda")
    grads = []
    reset_counters()
    for use_kernel in (True, False):
        img = origin.clone().requires_grad_(True)
        fl = flow.clone().requires_grad_(True)
        out = flow_warp_origin(img, fl, use_kernel=use_kernel)
        (out * weight).sum().backward()
        grads.append((out.detach(), img.grad, fl.grad))
    torch.cuda.synchronize()
    got = read_counters()
    check(got == counts(k5=1, k6=1), f"one K5 and one K6 launch, got {got}")
    for name, a, b in zip(("warped", "d/d image", "d/d flow"), *grads):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        print(f"flow_warp_origin kernel vs portable path, {name}: "
              f"max_abs_err={err} (max|ref|={scale})")
        check(err <= 1e-5 * scale, f"{name}: {err} <= 1e-5 * {scale}")
    return got


def fresh_train_state(mode, remat=False, base=STRAJNET_CONFIG):
    """A train state of ``base`` (default ``STRAJNET_CONFIG``) from seed-0
    weights in the given Swin-block mode (and ``remat_encoder``), with every
    bias drawn from N(0, 0.1) instead of the init's zeros.

    With all biases zero, a patch of an empty raster stays a constant token
    through every layer, each LayerNorm multiplies the gradient of the bias
    directions by eps^-1/2 = 316, and at this depth the squares of those
    gradients overflow f32 in Nadam's second moment, so such a parameter
    would never move. The JAX package computes the same gradients
    (``tests/test_torch_train_step.py`` holds the port to them at a small
    depth, where they already reach 1e25). Random biases keep the checks of
    this smoke out of that corner; :func:`real_init_report` prints what one
    step from the init itself does."""
    cfg = dataclasses.replace(base, use_pallas_attention=mode,
                              remat_encoder=remat)
    return bench.train_state(cfg, BATCH, "cuda"), cfg


def _first_step(mode, batch, remat=False, base=STRAJNET_CONFIG):
    """One training step from those weights and seed-0 noise: (loss dict,
    flat gradient, initial parameters, state, step function, noise)."""
    state, cfg = fresh_train_state(mode, remat, base)
    init = {k: v.detach().cpu().clone()
            for k, v in state.model.named_parameters()}
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                           cfg.num_waypoints)
    noise = torch.Generator(device="cuda").manual_seed(0)
    state, losses = step(state, batch, noise)
    torch.cuda.synchronize()
    for name, p in state.model.named_parameters():
        check(p.grad is not None, f"parameter {name} has a gradient")
    grads = torch.cat([p.grad.flatten().float()
                       for p in state.model.parameters()])
    check(bool(torch.isfinite(grads).all()), "gradients finite")
    return losses, grads, init, state, step, noise


def worst_leaves(model, grads, other_grads, count=5):
    """Each parameter's 1 - cos between two flat gradients of ``model``,
    worst first: [(1 - cos, |leaf gradient| / |whole gradient|, name)]."""
    rows, offset, whole = [], 0, float(grads.norm())
    for name, p in model.named_parameters():
        a = grads[offset:offset + p.numel()]
        b = other_grads[offset:offset + p.numel()]
        offset += p.numel()
        if name not in ZERO_GRAD_LEAVES:
            rows.append((one_minus_cos(a, b), float(a.norm()) / whole, name))
    return sorted(rows, reverse=True)[:count]


def real_init_report(batch) -> None:
    """One kernel-path step from ``create_train_state``'s own weights, zero
    biases included: prints which parameters it leaves where they were. Not
    a check: see :func:`fresh_train_state`."""
    cfg = STRAJNET_CONFIG
    state = create_train_state(cfg, TrainConfig(batch_size=BATCH),
                               torch.Generator().manual_seed(0), "cuda")
    init = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(), cfg.num_waypoints)
    state, losses = step(state, batch,
                         torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    named = dict(state.model.named_parameters())
    stuck = [n for n, p in named.items() if torch.equal(p.detach(), init[n])]
    top = max(named, key=lambda n: float(named[n].grad.abs().max()))
    finite = all(bool(torch.isfinite(p).all()) for p in named.values())
    print(f"one step from the entry point's own init (zero biases): total "
          f"loss {float(losses['total']):.6f}; parameters finite: {finite}; "
          f"largest gradient entry {float(named[top].grad.abs().max()):.4g} "
          f"in {top}; {len(stuck)} of {len(named)} parameters did not move: "
          + ", ".join(stuck[:12]) + (" ..." if len(stuck) > 12 else ""))


def train_steps():
    """Three flagship training steps at batch 16 through the kernels; then
    the first step again in the "block_fwd" mode and on the plain path, held
    against the kernel path's loss and gradients, whole and leaf by leaf;
    then one "attn" step (K3 forward, K4 backward) held against the plain
    path's; then one step from the init's own zero biases, reported only.
    Returns the counters over the three steps plus the "attn" step."""
    cfg = STRAJNET_CONFIG
    all_keys = MODEL_KEYS + ("gt_obs_ogm", "gt_occ_ogm", "gt_flow",
                             "origin_flow")
    batches = [to_device(synthetic_batch(cfg, BATCH, seed=i), all_keys)
               for i in range(3)]
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    losses, grads, init, state, step, noise = _first_step(None, batches[0])
    first_ms = (time.perf_counter() - t0) * 1e3
    check(read_counters() == counts(k1=8, k2=8, k5=1),
          f"launches of K1/K2/K5 in one step are 8/8/1 and no other, got "
          f"{read_counters()}")
    history, step_ms = [losses], []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss_dict = step(state, b, noise)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append(loss_dict)
    launches = read_counters()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    check(launches == counts(k1=24, k2=24, k5=3),
          f"launches of K1/K2/K5 over three steps are 24/24/3 and no other, "
          f"got {launches}")
    check(read_general_counters() == counts(GENERAL_COUNTERS),
          f"the flagship steps take the wgmma route only, got "
          f"{read_general_counters()} general launches")
    check(state.step == 3, f"step count 3, got {state.step}")
    for i, loss_dict in enumerate(history):
        vals = {k: float(v) for k, v in loss_dict.items()}
        print(f"train step {i}: " + " ".join(f"{k}={v:.6f}"
                                             for k, v in vals.items()))
        check(all(np.isfinite(v) for v in vals.values()),
              f"losses of step {i} finite")
    for name, p in state.model.named_parameters():
        check(bool(torch.isfinite(p).all()), f"parameter {name} finite")
        # fg_msa_layer.proj_k.bias shifts every logit of a softmax row
        # alike: its gradient is zero but for rounding, so it may stay put
        check(not torch.equal(p.detach().cpu(), init[name])
              or name == "fg_msa_layer.proj_k.bias",
              f"parameter {name} changed by training")
    grad_norm = float(grads.norm())
    print(f"training, batch {BATCH} bf16, kernel path: gradient norm of the "
          f"first step {grad_norm:.4g}; first step "
          f"{first_ms:.1f} ms (model and optimizer creation included), then "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} ms per step; peak "
          f"memory {peak_mb:.0f} MB; launches K1..K7 = {launches}")
    model = state.model
    del state, step

    # "block_fwd" and the plain path against the kernel path; then the
    # "attn" mode (K3 forward, K4 backward) against the plain path
    kernel_ref = ("kernel", grads, float(losses["total"]))
    compare_first_step(model, "block_fwd", batches[0],
                       counts(k1=8, k5=1), kernel_ref, "block_fwd")
    plain_grads, plain_total, _, _ = compare_first_step(
        model, False, batches[0], counts(k5=1), kernel_ref, False)
    del grads, kernel_ref
    attn_grads, attn_total, attn_launches, attn_mb = compare_first_step(
        model, "attn", batches[0], counts(k3=8, k4=8, k5=1),
        ("plain", plain_grads, plain_total), False)
    del plain_grads
    # remat_encoder recomputes each block's forward in the backward: K3
    # runs twice per block, and the step is the same step
    _, _, remat_launches, remat_mb = compare_first_step(
        model, "attn", batches[0], counts(k3=16, k4=8, k5=1),
        ("attn", attn_grads, attn_total), "remat", remat=True)
    print(f"remat_encoder, \"attn\" step: peak memory {remat_mb:.0f} MB "
          f"against {attn_mb:.0f} MB without")
    del model, attn_grads
    torch.cuda.empty_cache()
    real_init_report(batches[0])
    return tuple(a + b + c for a, b, c in zip(launches, attn_launches,
                                             remat_launches))


def compare_first_step(model, mode, batch, expect, reference, limits,
                       remat=False, base=STRAJNET_CONFIG):
    """The first training step of ``base`` in ``mode`` (with
    ``remat_encoder=remat``) against ``reference`` = (name, flat gradient,
    total loss) of another mode's first step, under the ``STEP_*[limits]``
    limits; also that the step moved the parameters. Returns (flat gradient,
    total loss, counters of the step, peak device memory of the step in MB:
    the model and its optimizer state included)."""
    ref_name, ref_grads, ref_total = reference
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    losses, grads, init, state = _first_step(mode, batch, remat, base)[:4]
    got = read_counters()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if remat:
        mode = f"{mode} + remat_encoder"
    check(got == expect, f"mode {mode!r}: launches {got}, expected {expect}")
    total = float(losses["total"])
    check(bool(np.isfinite(total)), f"mode {mode!r}: loss finite")
    stuck = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach().cpu(), init[n])
             and n not in ZERO_GRAD_LEAVES]
    check(not stuck, f"mode {mode!r}: parameters {stuck[:5]} did not move")
    del state, init
    omc = one_minus_cos(ref_grads, grads)
    leaves = worst_leaves(model, ref_grads, grads)
    print(f"first step, mode {mode!r} vs {ref_name} path: total loss "
          f"{total:.6f} vs {ref_total:.6f}; gradient 1-cos={omc:.3e}; peak "
          f"memory {peak_mb:.0f} MB; worst leaves by 1-cos (share of the "
          f"gradient's norm): "
          + ", ".join(f"{n} {v:.3e} ({share:.1e})" for v, share, n in leaves))
    check(abs(total - ref_total) <= STEP_LOSS_RTOL[limits] * abs(ref_total),
          f"mode {mode!r}: loss {total} within {STEP_LOSS_RTOL[limits]} of "
          f"{ref_total}")
    check(omc <= STEP_GRAD_ONE_MINUS_COS[limits],
          f"mode {mode!r}: gradient 1-cos {omc} <= "
          f"{STEP_GRAD_ONE_MINUS_COS[limits]}")
    check(leaves[0][0] <= STEP_LEAF_ONE_MINUS_COS[limits],
          f"mode {mode!r}: worst leaf {leaves[0][2]} 1-cos {leaves[0][0]} <= "
          f"{STEP_LEAF_ONE_MINUS_COS[limits]}")
    return grads, total, got, peak_mb


def eval_inputs(cfg, seeds):
    """Synthetic f32 eval batches whose map raster holds multiples of 1/256,
    as a record's int8 map divided by 256 does."""
    keys = MODEL_KEYS + ("gt_obs_ogm", "gt_occ_ogm", "gt_flow", "origin_flow")
    batches = [{k: b[k] for k in keys}
               for b in (synthetic_batch(cfg, BATCH, seed=s) for s in seeds)]
    for b in batches:
        b["map_image"] = np.floor(b["map_image"] * 256.0) / 256.0
    return batches


def compact_feed(batch):
    """The batch as ``infer/evaluate.py`` feeds it by default
    (``compact=True``, ``data/schema.py``): binary grids as uint8, the map
    raster as f16, the rest f32. Bit-exact for these values."""
    out = dict(batch)
    for k in ("ogm", "gt_obs_ogm", "gt_occ_ogm"):
        out[k] = batch[k].astype(np.uint8)
    out["map_image"] = batch["map_image"].astype(np.float16)
    return out


def eval_step_parts(model, batch, cfg):
    """CUDA-event times of the three parts of one eval step: forward, loss,
    metrics (ms)."""
    loss_fn = OGMFlowLoss(WAYMO_TASK_CONFIG, LossConfig())
    with torch.inference_mode():
        tb = ensure_f32(to_device(batch, tuple(batch)))
        true = true_waypoints_from_batch(tb)
        logits = split_pred_waypoints(forward(model, tb), cfg.num_waypoints)
        pred = apply_sigmoid_to_occupancy_logits(logits)
        return (cuda_ms(lambda: forward(model, tb), iters=3),
                cuda_ms(lambda: loss_fn(true, logits), iters=3),
                cuda_ms(lambda: compute_occupancy_flow_metrics(true, pred),
                        iters=3))


def eval_path(state):
    """The evaluation path at full width: two synthetic batches of 16 through
    ``infer.evaluate.evaluate_batches`` on a model with the window-attention
    kernel in all eight Swin blocks and the decoder-tail kernel in both
    tails, then through the same loop on the plain path; losses and metrics
    of the two held against each other. Returns the kernel run's counters."""
    cfg = dataclasses.replace(STRAJNET_CONFIG, use_pallas_attention="attn",
                              use_pallas_decoder_tail=True)
    plain_cfg = dataclasses.replace(STRAJNET_CONFIG,
                                    use_pallas_attention=False)
    batches = eval_inputs(cfg, (200, 201))
    eval_step = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(),
                               cfg.num_waypoints)
    results, seconds, models = [], [], []
    for c in (cfg, plain_cfg):
        model = STrajNet(c)
        model.load_state_dict(state)
        model = model.cuda().eval()
        evaluate_batches(model, eval_step, batches[:1])   # warm-up
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(evaluate_batches(model, eval_step, batches))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if c is cfg:
            launches = read_counters()
        models.append(model)
    check(launches == counts(k3=16, k5=4, k7=4),
          f"16 K3, 4 K5 and 4 K7 launches over two eval steps and no other, "
          f"got {launches}")
    res, plain = results
    print("eval path, kernels (attn + decoder-tail kernel):")
    print_metrics(res, "val")
    print(json.dumps({"eval": res, "eval_plain_path": plain}))
    check(len(res) == 12 and set(res) == set(plain),
          f"seven metrics and five losses, got {sorted(res)}")
    losses = ("val_observed_xe", "val_occluded_xe", "val_flow",
              "val_flow_warp_xe", "val_total")
    worst_loss = worst_metric = 0.0
    for k, v in res.items():
        check(bool(np.isfinite(v)), f"eval {k} finite")
        diff = abs(v - plain[k])
        rel = diff / abs(plain[k]) if plain[k] else 0.0
        print(f"  {k}: {v} vs plain path {plain[k]}, difference {diff:.3e} "
              f"({rel:.3e} relative)")
        if k in losses:
            worst_loss = max(worst_loss, rel)
            check(diff <= EVAL_LOSS_RTOL * abs(plain[k]),
                  f"eval loss {k}: {v} within {EVAL_LOSS_RTOL} of {plain[k]}")
        else:
            worst_metric = max(worst_metric, rel)
            check(diff <= EVAL_METRIC_RTOL * abs(plain[k]) + EVAL_METRIC_ATOL,
                  f"eval metric {k}: {v} within {EVAL_METRIC_RTOL} relative "
                  f"+ {EVAL_METRIC_ATOL} of {plain[k]}")
    n = len(batches) * BATCH
    parts = [eval_step_parts(m, batches[0], cfg) for m in models]
    print(f"eval path, batch {BATCH} bf16, two steps: kernels "
          f"{seconds[0] * 1e3 / 2:.1f} ms/step ({n / seconds[0]:.1f} "
          f"scenes/s), plain path {seconds[1] * 1e3 / 2:.1f} ms/step "
          f"({n / seconds[1]:.1f} scenes/s), host transfer included; worst "
          f"loss difference {worst_loss:.3e} relative, worst metric "
          f"difference {worst_metric:.3e} relative; launches K1..K7 = "
          f"{launches}")
    for name, (fwd, loss, met) in zip(("kernels", "plain path"), parts):
        print(f"  one eval step by CUDA events, {name}: forward {fwd:.3f} ms, "
              f"loss {loss:.3f} ms, metrics {met:.3f} ms")

    # the compact feed, which the CLI takes by default, through the same
    # kernel model: the same values, a third of the bytes to copy
    compact = [compact_feed(b) for b in batches]
    evaluate_batches(models[0], eval_step, compact[:1])   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_compact = evaluate_batches(models[0], eval_step, compact)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    worst = max(abs(v - res[k]) / max(abs(res[k]), 1e-30)
                for k, v in res_compact.items())
    print(f"eval path, kernels, compact feed (uint8 grids, f16 map): "
          f"{compact_s * 1e3 / 2:.1f} ms/step ({n / compact_s:.1f} scenes/s) "
          f"against {seconds[0] * 1e3 / 2:.1f} ms/step on the f32 feed; "
          f"worst difference to the f32 feed's results {worst:.3e} relative")
    check(set(res_compact) == set(res), "compact feed: the same keys")
    for k, v in res_compact.items():
        check(abs(v - res[k]) <= EVAL_METRIC_RTOL * abs(res[k])
              + EVAL_METRIC_ATOL,
              f"compact feed {k}: {v} within {EVAL_METRIC_RTOL} of {res[k]}")

    # the device prefetch against the pageable copies it replaced, both
    # feeds, six batches each
    more = eval_inputs(cfg, range(210, 216))
    for name, feed in (("f32", more),
                       ("compact", [compact_feed(b) for b in more])):
        eval_prefetch_ab(models[0], eval_step, feed, name)
    del more, feed

    # one batch from pageable host memory to the card, in either feed
    for name, batch in (("f32", batches[0]), ("compact", compact[0])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_device(batch, tuple(batch))
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        mb = sum(v.nbytes for v in batch.values()) / 2 ** 20
        print(f"  one batch to the card, {name} feed: {mb:.0f} MB in "
              f"{copy_ms:.1f} ms")
    return launches


def pageable_copies(batches, device):
    """The feed of ``evaluate_batches`` before the device prefetch: each
    numpy batch copied to the card from pageable memory when its step
    comes, on the consumer's thread."""
    for batch in batches:
        yield {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def eval_prefetch_ab(model, eval_step, batches, name):
    """``evaluate_batches`` over ``batches`` with the device prefetch and
    with the copies of the loop it replaced, in turns (without, with, three
    times); returns (ms/step without, ms/step with), each the mean of its
    turns, and holds the results of the two against each other."""
    evaluate_batches(model, eval_step, batches[:1])   # warm-up, pinned ring
    times, results = {}, {}
    for prefetch in (False, True) * 3:
        if not prefetch:
            evaluate_mod.prefetch_to_device = pageable_copies
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = evaluate_batches(model, eval_step, batches)
            torch.cuda.synchronize()
        finally:
            evaluate_mod.prefetch_to_device = prefetch_to_device
        times.setdefault(prefetch, []).append(
            (time.perf_counter() - t0) * 1e3 / len(batches))
        results.setdefault(prefetch, res)
    for k, v in results[True].items():
        ref = results[False][k]
        check(abs(v - ref) <= EVAL_METRIC_RTOL * abs(ref) + EVAL_METRIC_ATOL,
              f"{name} feed {k}: {v} with the prefetch, {ref} without")
    print(f"eval loop, {name} feed: results with and without the prefetch "
          f"bit-identical: {results[True] == results[False]}")
    print(f"eval loop, {name} feed, {len(batches)} batches of {BATCH}: "
          f"pageable copies {np.mean(times[False]):.1f} ms/step "
          f"({', '.join(f'{t:.1f}' for t in times[False])}), device prefetch "
          f"{np.mean(times[True]):.1f} ms/step "
          f"({', '.join(f'{t:.1f}' for t in times[True])})")
    return float(np.mean(times[False])), float(np.mean(times[True]))


class Tee(io.TextIOBase):
    """Standard output that is also kept, to read what the loop prints."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.out.write(s)
        self.text.append(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_loop(cfg, save_dir, epochs, source):
    """``train.loop.train`` on the card from ``save_dir``; returns (state,
    ms per train step of each epoch it ran, as the loop prints them, peak
    device MB of the call, counters of the call)."""
    tee = Tee(sys.stdout)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with contextlib.redirect_stdout(tee):
        state = train(cfg, train_cfg=TrainConfig(
            batch_size=BATCH, epochs=epochs, save_dir=save_dir),
            batches=source, device="cuda")
    torch.cuda.synchronize()
    launches = read_counters()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = [float(m) for m in re.findall(r"steps in [\d.]+ s \(([\d.]+) ms/step",
                                       "".join(tee.text))]
    return state, ms, peak_mb, launches


def write_step0(cfg, save_dir):
    """A step-0 checkpoint of ``fresh_train_state`` (biases from N(0, 0.1):
    the init's zero biases overflow Nadam at this depth), epoch 0; returns
    (seconds of the save, bytes of the checkpoint)."""
    state, _ = fresh_train_state(None, base=cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CheckpointManager(save_dir).save(
        0, state, metrics={"val_loss": 0.0, "epoch": 0, "steps_per_epoch": 0})
    seconds = time.perf_counter() - t0
    return seconds, os.path.getsize(os.path.join(save_dir, "0", "state.pt"))


def read_log(save_dir):
    with open(os.path.join(save_dir, "train_log.csv")) as f:
        return list(csv.DictReader(f))


def loop_phase():
    """The training loop, ``train.loop.train``, at ``STRAJNET_CONFIG``, batch
    16, on synthetic compact-feed batches (6 train, 2 val) handed in through
    ``batches=`` (no TensorFlow here): one epoch from a step-0 checkpoint,
    then a second run that resumes at epoch 1 and takes epoch 2. Checks the
    log, the checkpoints, the launches per step, and that the newest
    checkpoint restores bit for bit; times the loop against the bare step
    on the same batches already on the card, and a checkpoint's save and
    restore. Then three steps and one val batch of
    ``STRAJNET_TRAIN_PY_CONFIG`` (no FG-MSA). Returns the counters."""
    cfg = STRAJNET_CONFIG
    n_train, n_val = 6, 2
    train_batches = [compact_feed(b) for b in
                     eval_inputs(cfg, range(300, 300 + n_train))]
    val_batches = [compact_feed(b) for b in eval_inputs(cfg, (400, 401))]
    data = {"train": train_batches, "val": val_batches}

    def per_run(train_steps, val_steps):
        return counts(k1=8 * (train_steps + val_steps), k2=8 * train_steps,
                      k5=train_steps + 2 * val_steps)

    total = counts()
    with tempfile.TemporaryDirectory() as save_dir:
        save0_s, ckpt_bytes = write_step0(cfg, save_dir)
        source = lambda split, epoch: data[split]   # noqa: E731
        _, ms1, _, launches = run_loop(cfg, save_dir, 1, source)
        check(launches == per_run(n_train, n_val),
              f"epoch 1: launches {launches}, expected "
              f"{per_run(n_train, n_val)} (K1/K2/K5 8/8/1 per train step, "
              f"K1/K5 8/2 per val step)")
        check(CheckpointManager(save_dir).latest_step() == n_train,
              "a checkpoint after epoch 1")
        total = tuple(a + b for a, b in zip(total, launches))
        state, ms2, peak_mb, launches = run_loop(cfg, save_dir, 2, source)
        check(launches == per_run(n_train, n_val),
              f"resumed epoch 2: launches {launches}")
        total = tuple(a + b for a, b in zip(total, launches))
        check(len(ms1) == 1 and len(ms2) == 1,
              f"the resumed run took one epoch, got {ms1} then {ms2}")
        log = read_log(save_dir)
        check([r["epoch"] for r in log] == ["1", "2"],
              f"train_log.csv rows for epochs 1 and 2, got {log}")
        for row in log:
            check(all(np.isfinite(float(v)) for v in row.values()),
                  f"train_log.csv epoch {row['epoch']} finite: {row}")
        ckpt = CheckpointManager(save_dir)
        check(ckpt.latest_step() == 2 * n_train and state.step == 2 * n_train,
              f"latest step {ckpt.latest_step()}, state step {state.step}")
        check(ckpt.metadata()["epoch"] == 2, f"sidecar {ckpt.metadata()}")
        params, _ = ckpt.restore_params()
        live = state.model.state_dict()
        check(list(params) == list(live) and all(
            torch.equal(params[k], live[k].cpu()) for k in live),
            "restore_params equals the live model bit for bit")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as other:
            t0 = time.perf_counter()
            CheckpointManager(other).save(state.step, state)
            save_s = time.perf_counter() - t0
        print("train_log.csv:\n" + "\n".join(
            ", ".join(f"{k}={v}" for k, v in row.items()) for row in log))

        # the bare step on the same batches, already on the card, from the
        # loop's state (warm), twice; then the loop once more (epoch 3)
        on_card = [to_device(b, tuple(b)) for b in train_batches]
        step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                               cfg.num_waypoints, accumulate=True)
        noise = torch.Generator(device="cuda").manual_seed(0)
        state.model.train()
        bare_ms = []
        for _ in range(2):
            sums = zero_loss_sums("cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in on_card:
                state, sums = step(state, b, noise, sums)
            sums = torch.stack(list(sums.values())).tolist()
            bare_ms.append((time.perf_counter() - t0) * 1e3 / len(on_card))
            check(all(np.isfinite(v) for v in sums),
                  "bare steps: losses finite")
        del state, on_card, params, live
        _, ms3, _, launches = run_loop(cfg, save_dir, 3, source)
        check(len(ms3) == 1 and launches == per_run(n_train, n_val),
              f"resumed epoch 3: {ms3}, launches {launches}")
        total = tuple(a + b for a, b in zip(total, launches))
    loop_ms = (ms2[0] + ms3[0]) / 2
    bare = sum(bare_ms) / 2
    print(f"training loop, STRAJNET_CONFIG, batch {BATCH}, {n_train} steps an "
          f"epoch: epoch 1 {ms1[0]:.1f} ms/step (the process's first steps "
          f"of the loop), resumed epochs 2 and 3 {ms2[0]:.1f}, {ms3[0]:.1f} "
          f"ms/step against the bare make_train_step on the same batches on "
          f"the card between them {bare_ms[0]:.1f}, {bare_ms[1]:.1f} ms/step "
          f"({(loop_ms / bare - 1) * 100:+.1f} %); peak memory of the resumed "
          f"run {peak_mb:.0f} MB; checkpoint {ckpt_bytes} bytes, save "
          f"{save_s:.3f} s (step 0: {save0_s:.3f} s), restore {restore_s:.3f}"
          f" s; launches per train step K1/K2/K5 8/8/1, per val step K1/K5 "
          f"8/2")

    # the checked-in training variant: no FG-MSA, no flow head
    variant = STRAJNET_TRAIN_PY_CONFIG
    data = {"train": train_batches[:3], "val": val_batches[:1]}
    with tempfile.TemporaryDirectory() as save_dir:
        write_step0(variant, save_dir)
        state, ms_v, peak_v, launches = run_loop(
            variant, save_dir, 1, lambda split, epoch: data[split])
        check(launches == per_run(3, 1),
              f"STRAJNET_TRAIN_PY_CONFIG: launches {launches}, expected "
              f"{per_run(3, 1)}")
        check(not hasattr(state.model, "fg_msa_layer"),
              "STRAJNET_TRAIN_PY_CONFIG builds no FG-MSA")
        log = read_log(save_dir)
        check(len(log) == 1 and all(np.isfinite(float(v))
                                    for v in log[0].values()),
              f"STRAJNET_TRAIN_PY_CONFIG: finite log {log}")
        check(state.step == 3, f"three steps, got {state.step}")
        del state
    total = tuple(a + b for a, b in zip(total, launches))
    print(f"training loop, STRAJNET_TRAIN_PY_CONFIG (no FG-MSA), batch "
          f"{BATCH}: {ms_v[0]:.1f} ms/step over 3 steps, peak memory "
          f"{peak_v:.0f} MB, against STRAJNET_CONFIG's {loop_ms:.1f} ms/step "
          f"and {peak_mb:.0f} MB; loss {log[0]['loss']}, val_loss "
          f"{log[0]['val_loss']}")
    torch.cuda.empty_cache()
    return total


def variant_state(cfg):
    """Seed-0 weights of ``cfg`` with every bias and the absolute position
    embedding drawn from N(0, 0.1) instead of zeros."""
    state = init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for k, v in state.items():
        if k.endswith("bias") or k.endswith("absolute_pos_embed"):
            state[k] = torch.randn(v.shape, generator=g) * 0.1
    return state


def map_variant_training():
    """Three training steps at batch 16 of ``STRAJNET_CONFIG`` and of its
    map variant (``actor_only=False``: centerline encoder, eight
    per-waypoint map blocks) through the kernels, on the same batches, in
    one call: launches per step, finite losses, every parameter moved, step
    time and peak memory side by side. Then the map variant's first step on
    the plain path against the kernel path's. Returns the counters of the
    kernel runs."""
    variant = dataclasses.replace(STRAJNET_CONFIG, actor_only=False)
    all_keys = MODEL_KEYS + ("gt_obs_ogm", "gt_occ_ogm", "gt_flow",
                             "origin_flow")
    batches = [to_device(synthetic_batch(variant, BATCH, seed=600 + i),
                         all_keys) for i in range(3)]
    total, rows = counts(), {}
    for name, base in (("STRAJNET_CONFIG", STRAJNET_CONFIG),
                       ("actor_only=False", variant)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        losses, grads, init, state, step, noise = _first_step(
            None, batches[0], base=base)
        check(read_counters() == counts(k1=8, k2=8, k5=1),
              f"{name}: launches of K1/K2/K5 in one step are 8/8/1 and no "
              f"other, got {read_counters()}")
        history, step_ms = [losses], []
        for b in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss_dict = step(state, b, noise)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            history.append(loss_dict)
        launches = read_counters()
        check(launches == counts(k1=24, k2=24, k5=3),
              f"{name}: launches over three steps {launches}")
        total = tuple(a + b for a, b in zip(total, launches))
        for i, loss_dict in enumerate(history):
            vals = {k: float(v) for k, v in loss_dict.items()}
            print(f"{name}, train step {i}: " + " ".join(
                f"{k}={v:.6f}" for k, v in vals.items()))
            check(all(np.isfinite(v) for v in vals.values()),
                  f"{name}: losses of step {i} finite")
        stuck = [n for n, p in state.model.named_parameters()
                 if torch.equal(p.detach().cpu(), init[n])
                 and n not in ZERO_GRAD_LEAVES]
        check(not stuck, f"{name}: parameters {stuck[:5]} did not move")
        rows[name] = (step_ms, torch.cuda.max_memory_allocated() / 2 ** 20,
                      sum(p.numel() for p in state.model.parameters()))
        if base is variant:
            model = state.model
            kernel_ref = ("kernel", grads, float(losses["total"]))
        del state, step, grads, init
    for name, (step_ms, peak_mb, n_params) in rows.items():
        print(f"training, batch {BATCH} bf16, kernel path, {name}: "
              f"{', '.join(f'{t:.1f}' for t in step_ms)} ms per step after "
              f"the first; peak memory {peak_mb:.0f} MB; {n_params} "
              f"parameters")
    check(hasattr(model.trajnet_attn, "map_cross_attn"),
          "the map variant builds the map blocks")
    compare_first_step(model, False, batches[0], counts(k5=1), kernel_ref,
                       False, base=variant)
    del model, kernel_ref, batches
    torch.cuda.empty_cache()
    return total


def variant_forward(name, flags, batch_size, expect):
    """One eval-mode forward of ``STRAJNET_CONFIG`` with ``flags`` through
    the kernels against the plain path (kernels off) on the same weights.
    Returns the counters of the kernel forward."""
    cfg = dataclasses.replace(STRAJNET_CONFIG, **flags)
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False,
                                    use_pallas_decoder_tail=False)
    state = variant_state(cfg)
    models = []
    for c in (cfg, plain_cfg):
        m = STrajNet(c)
        m.load_state_dict(state)
        models.append(m.cuda().eval())
    batch = to_device(synthetic_batch(cfg, batch_size, seed=500))
    oh, ow = cfg.output_size
    with torch.inference_mode():
        reset_counters()
        y = forward(models[0], batch)
        torch.cuda.synchronize()
        got = read_counters()
        y_plain = forward(models[1], batch)
        ms = cuda_ms(lambda: forward(models[0], batch), iters=3)
    check(got == counts(**expect),
          f"variant {name}: launches {got}, expected {counts(**expect)}")
    check(tuple(y.shape) == (batch_size, oh, ow, 4 * cfg.num_waypoints),
          f"variant {name}: shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), f"variant {name}: output finite")
    omc = one_minus_cos(y, y_plain)
    print(f"variant {name}: forward [{batch_size},{oh},{ow},"
          f"{4 * cfg.num_waypoints}] kernels vs plain path 1-cos={omc:.3e}; "
          f"{ms:.3f} ms through the kernels; launches K1..K7 = {got}")
    check(omc <= FWD_ONE_MINUS_COS,
          f"variant {name}: 1-cos {omc} <= {FWD_ONE_MINUS_COS}")
    del models, batch, y, y_plain
    torch.cuda.empty_cache()
    return got


def rpe_bias_timing() -> None:
    """FG-MSA's rel-pos bias at the flagship shape (batch 16 x 8 groups =
    128 table slices of 31 x 31, 256 keys on the 16 x 16 grid, offsets
    bounded by 8): the window form (``ops/rpe_window.py``, which FG-MSA now
    takes) against the direct gather (``core/sampling.py::rpe_bias``, which
    it took before). Both in f32 must agree, the bias and its table and
    position gradients; then the forward and the forward plus backward of
    each as the model runs them (the window form with bf16 compute, the
    gather in f32), by device time, gather, window, window, gather."""
    g = torch.Generator(device="cuda").manual_seed(7)
    s, h = BATCH * 8, 16
    n = h * h
    table = torch.randn(s, 2 * h - 1, 2 * h - 1, 1, generator=g,
                        device="cuda") * 0.1
    # tanh-bounded offsets as FG-MSA draws them, kept off the integer
    # lattice: at a tie the two forms take different one-sided derivatives
    grid = ref_points(h, h, device="cuda").reshape(1, n, 2)
    pos = grid + torch.tanh(torch.randn(s, n, 2, generator=g,
                                        device="cuda")) * (h / 2.0 - 0.01)
    dout = torch.randn(s, n, n, 1, generator=g, device="cuda")
    forms = {
        "gather": lambda t, p: rpe_bias(t, p, (h, h)),
        "window": lambda t, p: rpe_window_bias(t, p, (h, h), h / 2.0,
                                               torch.bfloat16),
    }

    def value_and_grads(fn):
        t = table.detach().requires_grad_()
        p = pos.detach().requires_grad_()
        out = fn(t, p)
        return (out.detach(),) + torch.autograd.grad(out, (t, p), dout)

    window32 = value_and_grads(
        lambda t, p: rpe_window_bias(t, p, (h, h), h / 2.0))
    gather32 = value_and_grads(forms["gather"])
    for what, a, b in zip(("bias", "d/d table", "d/d pos"), window32,
                          gather32):
        omc = one_minus_cos(a, b)
        print(f"FG-MSA bias [{s},{n},{n},1], window form vs gather, f32, "
              f"{what}: 1-cos={omc:.3e} max_abs_err="
              f"{float((a - b).abs().max())} (max|gather|="
              f"{float(b.abs().max())})")
        check(omc <= RPE_ONE_MINUS_COS,
              f"FG-MSA bias {what}: 1-cos {omc} <= {RPE_ONE_MINUS_COS}")
    del window32, gather32
    times = {k: [] for k in forms}
    for name in ("gather", "window", "window", "gather"):
        fn = forms[name]

        def fwd():
            with torch.no_grad():
                fn(table, pos)

        times[name].append((kernel_ms(fwd),
                            kernel_ms(lambda: value_and_grads(fn))))
    for name, runs in times.items():
        print(f"FG-MSA bias, {name} form: forward "
              + " / ".join(f"{f:.3f}" for f, _ in runs) + " ms, backward "
              + " / ".join(f"{b - f:.3f}" for f, b in runs)
              + " ms (forward plus backward less forward; device time)")
    torch.cuda.empty_cache()


def variants_phase():
    """The model variants at full width: the map variant's training, one
    eval-mode forward per variant group against the plain path, FG-MSA's
    bias in its two forms. Returns the counters of the kernel runs."""
    total = map_variant_training()
    for name, flags, batch_size, expect in VARIANT_FORWARDS:
        got = variant_forward(name, flags, batch_size, expect)
        total = tuple(a + b for a, b in zip(total, got))
    rpe_bias_timing()
    return total


DDP_RANKS = 2
DDP_RANK_TIMEOUT_S = 300
DDP_TIMED_STEPS = 4
# BasicLayerDecoder at the encoder's second stage: 16^2 x 384 -> 32^2 x 192
DECODER_LAYER = dict(dim=384, input_resolution=(16, 16), depth=2,
                     num_heads=6, window_size=8, res_connection=True)


def loop_first_step(cfg, step0_dir, save_dir, batch):
    """One training step of ``train.loop.train`` from ``step0_dir``'s
    checkpoint (no val batch): (total loss as the log holds it, the flat
    gradient the step left, the counters)."""
    shutil.copytree(step0_dir, save_dir)
    state, _, _, launches = run_loop(
        cfg, save_dir, 1, lambda split, epoch: [batch] if split == "train"
        else [])
    grads = torch.cat([p.grad.flatten().float()
                       for p in unwrap(state.model).parameters()])
    check(bool(torch.isfinite(grads).all()), "loop step: gradients finite")
    total = float(read_log(save_dir)[0]["loss"])
    del state
    torch.cuda.empty_cache()
    return total, grads, launches


def ddp_rank(rank: int, directory: str) -> None:
    """One of the ``ddp`` phase's rank processes (``--ddp-rank``): joins a
    ``gloo`` group of ``DDP_RANKS`` on this card (NCCL refuses two ranks on
    one device), evaluates its half of the two val batches, takes one
    training step on its half of the train batch (batch 16 over the ranks),
    times ``DDP_TIMED_STEPS`` more, and saves what it saw to
    ``directory``."""
    init_distributed("cuda:0", backend="gloo",
                     init_method="file://" + os.path.join(directory, "store"),
                     rank=rank, world_size=DDP_RANKS)
    try:
        cfg = STRAJNET_CONFIG
        half = BATCH // DDP_RANKS
        train_batch = eval_inputs(cfg, (600,))[0]
        val_batches = eval_inputs(cfg, (601, 602))

        def mine(batch):
            return {k: torch.from_numpy(
                np.ascontiguousarray(v[rank * half:(rank + 1) * half])
            ).cuda() for k, v in batch.items()}

        state, _ = fresh_train_state(None)
        check(type(state.model).__name__ == "DistributedDataParallel",
              "the rank's model is wrapped in DDP")
        eval_step = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(),
                                   cfg.num_waypoints)
        state.model.eval()
        reset_counters()
        val = [eval_step(state.model, mine(b)) for b in val_batches]
        torch.cuda.synchronize()
        val_launches = read_counters()
        state.model.train()
        step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                               cfg.num_waypoints)
        noise = torch.Generator(device="cuda").manual_seed(0)
        batch = mine(train_batch)
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        allreduce_sum_hook.bytes = 0
        state, losses = step(state, batch, noise)
        torch.cuda.synchronize()
        train_launches = read_counters()
        step_bytes = allreduce_sum_hook.bytes
        grads = torch.cat([p.grad.flatten().float()
                           for p in unwrap(state.model).parameters()])
        t0 = time.perf_counter()
        for _ in range(DDP_TIMED_STEPS):
            state, _ = step(state, batch, noise)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / DDP_TIMED_STEPS
        result = dict(
            losses={k: float(v) for k, v in losses.items()},
            val_losses=[{k: float(v) for k, v in l.items()} for l, _ in val],
            val_metrics=[{k: float(v) for k, v in m.items()} for _, m in val],
            val_launches=val_launches, train_launches=train_launches,
            step_bytes=step_bytes, ms_per_step=ms,
            peak_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
            grads=grads.cpu() if rank == 0 else None)
        torch.save(result, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        destroy()


def run_ranks(directory: str, ranks: int = None, flag: str = "--ddp",
              timeout_s: float = None):
    """Starts the rank processes (``ranks``, default ``DDP_RANKS``, of
    :func:`ddp_rank`, or of :func:`tp_rank` with ``flag="--tp"``) and waits
    for them, each within ``timeout_s`` (default ``DDP_RANK_TIMEOUT_S``); a
    rank that fails or hangs fails the phase. Returns their results and
    seconds."""
    ranks = DDP_RANKS if ranks is None else ranks
    timeout_s = DDP_RANK_TIMEOUT_S if timeout_s is None else timeout_s
    t0 = time.perf_counter()
    logs = [open(os.path.join(directory, f"rank{r}.log"), "w")
            for r in range(ranks)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag + "-rank", str(r),
         flag + "-dir", directory], stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(directory, f"rank{r}.log")) as f:
                print(f.read()[-6000:])
        check(p.returncode == 0,
              f"rank {r} of {ranks} exited with {p.returncode}")
    return ([torch.load(os.path.join(directory, f"rank{r}.pt"),
                        weights_only=False) for r in range(ranks)],
            time.perf_counter() - t0)


def check_decoder_layer():
    """``BasicLayerDecoder`` at C/2 = 192, batch 16, bf16, forward and
    backward through K1 and K2 against its plain path from the same
    weights: output, input gradient and whole parameter gradient within
    ``FWD_ONE_MINUS_COS``. Returns the kernel run's counters."""
    g = torch.Generator().manual_seed(3)
    ref = BasicLayerDecoder(**DECODER_LAYER, kernel_mode=False,
                            dtype=torch.bfloat16)
    params = {}
    for name, p in ref.state_dict().items():
        noise = torch.randn(p.shape, generator=g)
        if "norm" in name and name.endswith("weight"):
            params[name] = 1.0 + 0.1 * noise
        elif p.dim() >= 2 and "relative_position" not in name:
            params[name] = noise / np.sqrt(p[0].numel())
        else:
            params[name] = 0.1 * noise
    h, w = DECODER_LAYER["input_resolution"]
    c = DECODER_LAYER["dim"]
    x = torch.randn(BATCH, h, w, c, generator=g).cuda()
    res = torch.randn(BATCH, 2 * h, 2 * w, c // 2, generator=g).cuda()
    dy = torch.randn(BATCH, 2 * h, 2 * w, c // 2, generator=g).cuda()
    runs = {}
    for mode in (False, "block"):
        layer = BasicLayerDecoder(**DECODER_LAYER, kernel_mode=mode,
                                  dtype=torch.bfloat16)
        layer.load_state_dict(params)
        layer = layer.cuda().train()
        xi = x.clone().requires_grad_()
        reset_counters()
        y = layer(xi, res)
        y.float().backward(dy)
        torch.cuda.synchronize()
        runs[mode] = (y.detach().float(), xi.grad, torch.cat(
            [p.grad.flatten().float() for p in layer.parameters()]),
            read_counters())
    plain, kern = runs[False], runs["block"]
    check(plain[3] == counts(), f"plain decoder layer: launches {plain[3]}")
    check(kern[3] == counts(k1=2, k2=2),
          f"decoder layer: launches {kern[3]}, expected K1 2, K2 2")
    errs = [one_minus_cos(a, b) for a, b in zip(kern[:3], plain[:3])]
    print(f"BasicLayerDecoder (16^2 x 384 -> 32^2 x 192, 6 heads, depth 2, "
          f"1x1-conv residual), batch {BATCH}, bf16, K1/K2 vs plain: output "
          f"1-cos={errs[0]:.3e}, input gradient {errs[1]:.3e}, parameter "
          f"gradient {errs[2]:.3e}")
    for what, err in zip(("output", "input gradient", "parameter gradient"),
                         errs):
        check(err <= FWD_ONE_MINUS_COS,
              f"decoder layer {what}: 1-cos {err} <= {FWD_ONE_MINUS_COS}")
    return kern[3]


def ddp_phase():
    """Data parallelism at ``STRAJNET_CONFIG``, batch 16: (i) the training
    loop under a world-size-1 NCCL group (the model in DDP) against the
    plain one-device loop, first step and ms/step, parent-style in turns;
    (ii) two ``gloo`` rank processes on this card at 8 each against one
    process at 16 on the same batches: the first step, then two val
    batches; (iii) each rank's launches, peak memory and the bytes its
    gradients all-reduce; (iv) ``BasicLayerDecoder`` through K1 and K2.
    Returns the counters of this process's runs and the ranks'."""
    cfg = STRAJNET_CONFIG
    train_batches = [compact_feed(b) for b in
                     eval_inputs(cfg, range(500, 500 + DDP_TIMED_STEPS))]
    total = counts()

    def add(launches):
        nonlocal total
        total = tuple(a + b for a, b in zip(total, launches))

    with tempfile.TemporaryDirectory() as root:
        step0 = os.path.join(root, "step0")
        write_step0(cfg, step0)
        source = lambda split, epoch: (   # noqa: E731
            train_batches if split == "train" else [])

        def timed(name):
            _, ms, peak, launches = run_loop(
                cfg, shutil.copytree(step0, os.path.join(root, name)), 1,
                source)
            check(launches == counts(k1=8 * DDP_TIMED_STEPS,
                                     k2=8 * DDP_TIMED_STEPS,
                                     k5=DDP_TIMED_STEPS),
                  f"{name}: launches {launches}")
            add(launches)
            torch.cuda.empty_cache()
            return ms[0], peak

        plain_total, plain_grads, launches = loop_first_step(
            cfg, step0, os.path.join(root, "plain0"), train_batches[0])
        add(launches)
        plain_ms = [timed("plain1")]
        init_distributed("cuda:0", init_method="file://" + os.path.join(
            root, "store"), rank=0, world_size=1)
        try:
            allreduce_sum_hook.bytes = 0
            ddp_total, ddp_grads, launches = loop_first_step(
                cfg, step0, os.path.join(root, "ddp0"), train_batches[0])
            step_bytes = allreduce_sum_hook.bytes
            add(launches)
            ddp_ms = [timed("ddp1"), timed("ddp2")]
        finally:
            destroy()
        plain_ms.append(timed("plain2"))
    model = STrajNet(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    omc = one_minus_cos(plain_grads, ddp_grads)
    leaves = worst_leaves(model, plain_grads, ddp_grads)
    print(f"ddp (i): the loop under a world-size-1 NCCL group against the "
          f"plain loop, batch {BATCH}: first-step loss {ddp_total:.7f} vs "
          f"{plain_total:.7f}, gradient 1-cos={omc:.3e}, worst leaf "
          f"{leaves[0][2]} {leaves[0][0]:.3e}; {DDP_TIMED_STEPS}-step epochs "
          f"plain {plain_ms[0][0]:.1f}, DDP {ddp_ms[0][0]:.1f}, DDP "
          f"{ddp_ms[1][0]:.1f}, plain {plain_ms[1][0]:.1f} ms/step; peak "
          f"MB plain {plain_ms[0][1]:.0f} / {plain_ms[1][1]:.0f}, DDP "
          f"{ddp_ms[0][1]:.0f} / {ddp_ms[1][1]:.0f}; {step_bytes} bytes "
          f"all-reduced in the step ({n_params} f32 parameters)")
    check(abs(ddp_total - plain_total) <= STEP_LOSS_RTOL["block_fwd"]
          * abs(plain_total), "ddp (i): loss")
    check(omc <= STEP_GRAD_ONE_MINUS_COS["block_fwd"], "ddp (i): gradient")
    check(leaves[0][0] <= STEP_LEAF_ONE_MINUS_COS["block_fwd"],
          "ddp (i): worst leaf")
    check(step_bytes == 4 * n_params, f"ddp (i): {step_bytes} bytes reduced")

    # (ii) one process at 16, then two ranks at 8 on the same batches
    train_batch = eval_inputs(cfg, (600,))[0]
    val_batches = eval_inputs(cfg, (601, 602))
    state, _ = fresh_train_state(None)
    eval_step = make_eval_step(WAYMO_TASK_CONFIG, LossConfig(),
                               cfg.num_waypoints)
    state.model.eval()
    single_val = [eval_step(state.model, to_device(b, tuple(b)))
                  for b in val_batches]
    single_val = [({k: float(v) for k, v in l.items()},
                   {k: float(v) for k, v in m.items()})
                  for l, m in single_val]
    state.model.train()
    step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                           cfg.num_waypoints)
    state, losses = step(state, to_device(train_batch, tuple(train_batch)),
                         torch.Generator(device="cuda").manual_seed(0))
    single_total = float(losses["total"])
    single_grads = torch.cat([p.grad.flatten().float()
                              for p in state.model.parameters()])
    del state, losses
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as directory:
        ranks, seconds = run_ranks(directory)
    rank_total = sum(r["losses"]["total"] for r in ranks)
    omc = one_minus_cos(single_grads.cpu(), ranks[0]["grads"])
    leaves = worst_leaves(model, single_grads.cpu(), ranks[0]["grads"])
    print(f"ddp (ii): {DDP_RANKS} gloo ranks on this card at "
          f"{BATCH // DDP_RANKS} each against one process at {BATCH} "
          f"({seconds:.1f} s for the ranks): first-step loss {rank_total:.7f}"
          f" (shares " + ", ".join(f"{r['losses']['total']:.7f}"
                                   for r in ranks)
          + f") vs {single_total:.7f}, gradient 1-cos={omc:.3e}, worst leaf "
          f"{leaves[0][2]} {leaves[0][0]:.3e}")
    check(abs(rank_total - single_total) <= STEP_LOSS_RTOL["block_fwd"]
          * abs(single_total), "ddp (ii): loss")
    check(omc <= STEP_GRAD_ONE_MINUS_COS["block_fwd"], "ddp (ii): gradient")
    check(leaves[0][0] <= STEP_LEAF_ONE_MINUS_COS["block_fwd"],
          "ddp (ii): worst leaf")
    for i, (losses, metrics) in enumerate(single_val):
        for k, v in losses.items():
            got = sum(r["val_losses"][i][k] for r in ranks)
            check(abs(got - v) <= EVAL_LOSS_RTOL * abs(v) + EVAL_METRIC_ATOL,
                  f"ddp (ii) val batch {i} loss {k}: {got} vs {v}")
        for r in ranks:
            for k, v in metrics.items():
                got = r["val_metrics"][i][k]
                check(abs(got - v) <= EVAL_METRIC_RTOL * abs(v)
                      + EVAL_METRIC_ATOL,
                      f"ddp (ii) val batch {i} metric {k}: {got} vs {v}")
    print("ddp (ii) val: " + "; ".join(
        f"batch {i} total {sum(r['val_losses'][i]['total'] for r in ranks):.6f}"
        f" vs {l['total']:.6f}, obs AUC "
        f"{ranks[0]['val_metrics'][i]['vehicles_observed_auc']:.6f} vs "
        f"{m['vehicles_observed_auc']:.6f}"
        for i, (l, m) in enumerate(single_val)))
    for i, r in enumerate(ranks):
        # (iii)
        print(f"ddp (iii) rank {i}: launches K1/K2/K5 a train step "
              f"{r['train_launches'][0]}/{r['train_launches'][1]}/"
              f"{r['train_launches'][4]}, K1/K5 over 2 val steps "
              f"{r['val_launches'][0]}/{r['val_launches'][4]}; peak "
              f"{r['peak_mb']:.0f} MB; {r['step_bytes']} gradient bytes "
              f"all-reduced a step; {r['ms_per_step']:.1f} ms/step (both "
              f"ranks on one card, gloo through the host)")
        check(r["train_launches"] == counts(k1=8, k2=8, k5=1),
              f"rank {i}: train launches {r['train_launches']}")
        check(r["val_launches"] == counts(k1=16, k5=4),
              f"rank {i}: val launches {r['val_launches']}")
        check(r["step_bytes"] == 4 * n_params,
              f"rank {i}: {r['step_bytes']} bytes reduced")
        add(r["train_launches"])
        add(r["val_launches"])
    add(check_decoder_layer())
    torch.cuda.empty_cache()
    return total


TP_RANKS = 2
TP_RANK_TIMEOUT_S = 600
TP_TIMED_STEPS = 3
TP_DRYRUN_DEVICES = 4
# The step on a 1 x 2 mesh against one process on the same batch, bf16:
# the Swin blocks run the same kernels on the same inputs, but TrajNet's
# head-parallel attention and its row-parallel FFN round their partial
# sums to bf16 before the sum over 'model', so the order of bf16 additions
# changes there. Total loss relative, whole gradient 1 - cos, each loss term
# and val metric relative (the eval path's limits).
TP_LOSS_RTOL = 1e-4
TP_GRAD_ONE_MINUS_COS = 1e-4
TP_TERM_RTOL = 2e-3


def _whole_grads(model):
    """The flat gradient of ``model`` with each sharded parameter's gathered
    whole over 'model' (a collective: both ranks call it)."""
    flat = []
    for p in unwrap(model).parameters():
        dim = tp.placement(p)
        g = p.grad if dim is None else tp.all_gather(p.grad, dim, tp.MODEL)
        flat.append(g.flatten().float())
    return torch.cat(flat)


def _replicated_agree(model) -> bool:
    """Whether every parameter not split over 'model' is bit-equal on the
    peers along 'model' (a collective: both ranks call it)."""
    flat = torch.cat([p.detach().flatten() for p in unwrap(model).parameters()
                      if tp.placement(p) is None])
    peers = tp.all_gather(flat[None], 0, tp.MODEL)
    return bool((peers == peers[0]).all())


def tp_rank(rank: int, directory: str) -> None:
    """One of the ``tp`` phase's rank processes (``--tp-rank``): joins a
    ``gloo`` group of ``TP_RANKS`` on this card, builds a 1 x TP_RANKS
    ``('data', 'model')`` mesh, and on it evaluates one val batch and takes
    one training step at batch 16 in the default mode and one in the
    ``"attn"`` mode (launches, losses, metrics, the whole gradient, the
    bytes moved over each axis), times ``TP_TIMED_STEPS`` more default
    steps and then holds the replicated parameters bit-equal across the
    ranks, and runs the forward with and without ``spatial_shard``."""
    init_distributed("cuda:0", backend="gloo",
                     init_method="file://" + os.path.join(directory, "store"),
                     rank=rank, world_size=TP_RANKS)
    try:
        mesh = tp.create_mesh(TP_RANKS, "cuda")
        cfg = STRAJNET_CONFIG
        batch = eval_inputs(cfg, (600,))[0]
        batch = to_device(batch, tuple(batch))
        val = eval_inputs(cfg, (601,))[0]
        val = to_device(val, tuple(val))
        result = dict(coord=tuple(mesh.get_coordinate()))
        with tp.use_mesh(mesh):
            for mode in (None, "attn"):
                state, _ = fresh_train_state(mode)
                check(type(state.model).__name__ == "STrajNet",
                      "a data axis of one rank runs no DDP")
                step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                                       cfg.num_waypoints)
                got = {}
                if mode is None:
                    eval_step = make_eval_step(WAYMO_TASK_CONFIG,
                                               LossConfig(),
                                               cfg.num_waypoints)
                    state.model.eval()
                    reset_counters()
                    losses, metrics = eval_step(state.model, val)
                    torch.cuda.synchronize()
                    got.update(val_launches=read_counters(),
                               val_losses={k: float(v)
                                           for k, v in losses.items()},
                               val_metrics={k: float(v)
                                            for k, v in metrics.items()})
                    state.model.train()
                noise = torch.Generator(device="cuda").manual_seed(0)
                before = dict(tp.collective_bytes)
                torch.cuda.reset_peak_memory_stats()
                reset_counters()
                state, losses = step(state, batch, noise)
                torch.cuda.synchronize()
                got.update(
                    launches=read_counters(),
                    losses={k: float(v) for k, v in losses.items()},
                    moved={k: tp.collective_bytes[k] - before[k]
                           for k in before},
                    split=sum(tp.placement(p) is not None
                              for p in state.model.parameters()))
                grads = _whole_grads(state.model)
                check(bool(torch.isfinite(grads).all()), "gradients finite")
                got["grads"] = grads.cpu() if rank == 0 else None
                if mode is None:
                    t0 = time.perf_counter()
                    for _ in range(TP_TIMED_STEPS):
                        state, _ = step(state, batch, noise)
                    torch.cuda.synchronize()
                    got["ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                          / TP_TIMED_STEPS)
                    got["peak_mb"] = (torch.cuda.max_memory_allocated()
                                      / 2 ** 20)
                    got["replicated_equal"] = _replicated_agree(state.model)
                result[mode or "block"] = got
                del state, step, losses
                torch.cuda.empty_cache()
            outs = {}
            for sp in (False, True):
                state, _ = fresh_train_state(
                    None, base=dataclasses.replace(cfg, spatial_shard=sp))
                state.model.eval()
                with torch.inference_mode(), tp.record_hints() as hints:
                    outs[sp] = (forward(state.model, val), list(hints))
                del state
            result["sp_equal"] = torch.equal(outs[False][0], outs[True][0])
            result["hints"] = outs[True][1]
            result["no_hints"] = outs[False][1]
        torch.save(result, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        destroy()


def tp_phase():
    """Tensor parallelism at ``STRAJNET_CONFIG``, full depth and width,
    bf16, batch 16 (``parallel/mesh.py``): (i) two ``gloo`` rank processes
    on this card on a 1 x 2 mesh ('data' 1, 'model' 2) against one process
    on the same batches: one val batch, the first training step in the
    default mode and in ``"attn"``, launches on each rank, losses, terms,
    metrics and gradients within the limits above, the replicated
    parameters bit-equal across the ranks after the timed steps; each
    rank's ms per step against one process, peak MB and the bytes moved
    over each axis in a step; (ii) ``spatial_shard=True`` on the same mesh:
    the forward bit-equal, the hinted activations recorded with their split
    over 'model'; (iii)
    ``dryrun_multichip`` over four ranks on a 2 x 2 mesh. Returns the
    counters of the single process's runs and of the ranks' steps."""
    cfg = STRAJNET_CONFIG
    batch = eval_inputs(cfg, (600,))[0]
    batch = to_device(batch, tuple(batch))
    val = eval_inputs(cfg, (601,))[0]
    val = to_device(val, tuple(val))
    total = counts()

    def add(launches):
        nonlocal total
        total = tuple(a + b for a, b in zip(total, launches))

    single = {}
    for mode in (None, "attn"):
        state, _ = fresh_train_state(mode)
        step = make_train_step(WAYMO_TASK_CONFIG, LossConfig(),
                               cfg.num_waypoints)
        got = {}
        reset_counters()
        if mode is None:
            state.model.eval()
            losses, metrics = make_eval_step(
                WAYMO_TASK_CONFIG, LossConfig(), cfg.num_waypoints)(
                    state.model, val)
            got.update(val_losses={k: float(v) for k, v in losses.items()},
                       val_metrics={k: float(v) for k, v in metrics.items()})
            state.model.train()
        noise = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        state, losses = step(state, batch, noise)
        got["losses"] = {k: float(v) for k, v in losses.items()}
        got["grads"] = torch.cat([p.grad.flatten().float()
                                  for p in state.model.parameters()]).cpu()
        if mode is None:
            t0 = time.perf_counter()
            for _ in range(TP_TIMED_STEPS):
                state, _ = step(state, batch, noise)
            torch.cuda.synchronize()
            got["ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                  / TP_TIMED_STEPS)
            got["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
        torch.cuda.synchronize()
        add(read_counters())
        single[mode or "block"] = got
        del state, step, losses
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as directory:
        ranks, seconds = run_ranks(directory, TP_RANKS, "--tp",
                                   TP_RANK_TIMEOUT_S)
    model = STrajNet(cfg)
    smi = gpu_identity()
    for mode, expect in (("block", counts(k1=8, k2=8, k5=1)),
                         ("attn", counts(k3=8, k4=8, k5=1))):
        want = single[mode]
        rank_total = ranks[0][mode]["losses"]["total"]
        rel = abs(rank_total - want["losses"]["total"]) / abs(
            want["losses"]["total"])
        omc = one_minus_cos(want["grads"], ranks[0][mode]["grads"])
        leaves = worst_leaves(model, want["grads"], ranks[0][mode]["grads"])
        terms = {k: abs(ranks[0][mode]["losses"][k] - v) / max(abs(v), 1e-30)
                 for k, v in want["losses"].items()}
        print(f"tp (i) {mode}: {TP_RANKS} gloo ranks on a 1x{TP_RANKS} mesh "
              f"({ranks[0][mode]['split']} parameters split over 'model'; "
              f"{seconds:.1f} s for the ranks) against one process, batch "
              f"{BATCH}, bf16: loss {rank_total:.7f} vs "
              f"{want['losses']['total']:.7f}, relative {rel:.3e} (limit "
              f"{TP_LOSS_RTOL:g}); gradient 1-cos {omc:.3e} (limit "
              f"{TP_GRAD_ONE_MINUS_COS:g}), worst leaf {leaves[0][2]} "
              f"{leaves[0][0]:.3e}; worst term "
              f"{max(terms, key=terms.get)} {max(terms.values()):.3e} "
              f"(limit {TP_TERM_RTOL:g})")
        check(rel <= TP_LOSS_RTOL, f"tp (i) {mode}: loss")
        check(omc <= TP_GRAD_ONE_MINUS_COS, f"tp (i) {mode}: gradient")
        for k, err in terms.items():
            check(err <= TP_TERM_RTOL, f"tp (i) {mode}: term {k} {err}")
        for r, out in enumerate(ranks):
            got = out[mode]
            check(got["losses"] == ranks[0][mode]["losses"],
                  f"tp (i) {mode}: rank {r} has rank 0's losses")
            check(got["launches"] == expect,
                  f"tp (i) {mode}: rank {r} launches {got['launches']}, "
                  f"expected {expect}")
            add(got["launches"])
    for r, out in enumerate(ranks):
        got = out["block"]
        check(got["replicated_equal"], f"tp (i) rank {r}: the replicated "
              f"parameters differ across 'model' after "
              f"{TP_TIMED_STEPS + 1} steps")
        check(got["val_launches"] == counts(k1=8, k5=2),
              f"tp (i) rank {r}: val launches {got['val_launches']}")
        add(got["val_launches"])
        worst = {}
        for k, v in single["block"]["val_losses"].items():
            worst[k] = abs(got["val_losses"][k] - v) / max(abs(v), 1e-30)
            check(worst[k] <= TP_TERM_RTOL, f"tp (i) val loss {k}")
        for k, v in single["block"]["val_metrics"].items():
            err = abs(got["val_metrics"][k] - v)
            worst[k] = err / max(abs(v), 1e-30)
            check(err <= TP_TERM_RTOL * abs(v) + EVAL_METRIC_ATOL,
                  f"tp (i) val metric {k}: {got['val_metrics'][k]} vs {v}")
        k = max(worst, key=worst.get)
        print(f"tp (i) rank {r} at {out['coord']}: launches K1/K2/K5 a "
              f"train step {got['launches'][0]}/{got['launches'][1]}/"
              f"{got['launches'][4]}, K3/K4/K5 in 'attn' "
              f"{out['attn']['launches'][2]}/{out['attn']['launches'][3]}/"
              f"{out['attn']['launches'][4]}, K1/K5 an eval step "
              f"{got['val_launches'][0]}/{got['val_launches'][4]}; worst val "
              f"term or metric {k} {worst[k]:.3e} (limit {TP_TERM_RTOL:g}); "
              f"{got['ms_per_step']:.1f} ms/step against one process's "
              f"{single['block']['ms_per_step']:.1f} (both ranks on one "
              f"card, collectives through gloo); peak "
              f"{got['peak_mb']:.0f} MB against "
              f"{single['block']['peak_mb']:.0f}; bytes moved a step: "
              f"'model' {got['moved']['model']}, 'data' "
              f"{got['moved']['data']} ('attn' step: 'model' "
              f"{out['attn']['moved']['model']}); replicated parameters "
              f"bit-equal across 'model' after {TP_TIMED_STEPS + 1} steps "
              f"[{smi}]")
        # (ii)
        check(out["sp_equal"], f"tp (ii) rank {r}: spatial_shard forward "
              f"bit-equal")
        check(out["no_hints"] == [], "tp (ii): no hints without the flag")
        enc = [h for h in out["hints"] if len(h[0]) == 3]
        dec = [h for h in out["hints"] if len(h[0]) == 5]
        check(enc and dec, "tp (ii): encoder and decoder activations hinted")
        for axes, local, whole in out["hints"]:
            d = axes.index("model")
            check(local[d] * TP_RANKS == whole[d],
                  f"tp (ii): {axes} {local} of {whole}")
        print(f"tp (ii) rank {r}: spatial_shard forward bit-equal; "
              f"{len(out['hints'])} activations hinted split over 'model' "
              f"(recorded, not moved): encoder {enc[0][2]} -> local {enc[0][1]}, "
              f"decoder {dec[0][2]} -> local {dec[0][1]}")
    # (iii)
    t0 = time.perf_counter()
    lines = graft_entry.dryrun_multichip(TP_DRYRUN_DEVICES, device="cuda",
                                         timeout_s=TP_RANK_TIMEOUT_S)
    check(len(lines) == 3, f"tp (iii): dryrun_multichip printed {lines}")
    for ln in lines:
        check("mesh=(2x2)" in ln and np.isfinite(float(ln.split("loss=")[1])),
              f"tp (iii): {ln}")
    print(f"tp (iii) dryrun_multichip({TP_DRYRUN_DEVICES}) on this card: "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return total


PREPROCESS_SCENARIOS = 4


def womd_scenario(seed: int):
    """One WOMD scenario at the tf_example's full sizes (128 agents x 91
    steps, 20 000 roadgraph samples) as ``parse_womd_example`` gives it,
    made from a seed: vehicles, pedestrians, cyclists and others moving
    straight at their own speed and heading within 60 m of the SDC; a
    sixth of them seen only in the future (occluded), a sixth that drop out
    mid-history, a sixth that leave in the future; 400 polylines of 50
    samples over the road types."""
    rng = np.random.default_rng(seed)
    a = NUM_AGENTS
    t = (np.arange(NUM_PAST_STEPS + 1 + NUM_FUTURE_STEPS)
         - NUM_PAST_STEPS) * 0.1  # seconds from the current step
    types = rng.choice([1, 2, 3, 4], a, p=[0.6, 0.2, 0.15, 0.05])
    types[0] = 1
    speed = np.choose(types - 1, [10.0, 1.4, 5.0, 3.0]) * rng.uniform(0, 1.5,
                                                                      a)
    heading = rng.uniform(-np.pi, np.pi, a)
    vx, vy = speed * np.cos(heading), speed * np.sin(heading)
    x0, y0 = rng.uniform(-60, 60, (2, a))
    x0[0] = y0[0] = 0.0
    length = np.choose(types - 1, [4.5, 0.6, 1.8, 2.0]) * rng.uniform(
        0.8, 1.3, a)
    width = np.choose(types - 1, [2.0, 0.6, 0.7, 1.0]) * rng.uniform(
        0.8, 1.2, a)
    steps = t.size
    fields = {
        "x": x0[:, None] + vx[:, None] * t,
        "y": y0[:, None] + vy[:, None] * t,
        "bbox_yaw": heading[:, None] + rng.normal(0, 0.02, (a, steps)),
        "length": np.repeat(length[:, None], steps, 1),
        "width": np.repeat(width[:, None], steps, 1),
        "velocity_x": np.repeat(vx[:, None], steps, 1),
        "velocity_y": np.repeat(vy[:, None], steps, 1),
    }
    valid = np.ones((a, steps), np.int64)
    picks = rng.permutation(np.arange(1, a))
    k = a // 6
    valid[picks[:k], :NUM_PAST_STEPS + 1] = 0
    valid[picks[k:2 * k], 5:NUM_PAST_STEPS + 1] = 0
    valid[picks[2 * k:3 * k], 50:] = 0
    s = {"state/type": types.astype(np.float32),
         "state/is_sdc": (np.arange(a) == 0).astype(np.int64)}
    for time, lo, hi in (("past", 0, NUM_PAST_STEPS),
                         ("current", NUM_PAST_STEPS, NUM_PAST_STEPS + 1),
                         ("future", NUM_PAST_STEPS + 1, steps)):
        for name, value in fields.items():
            s[f"state/{time}/{name}"] = value[:, lo:hi].astype(np.float32)
        s[f"state/{time}/valid"] = valid[:, lo:hi]
    lines, per_line = 400, NUM_ROADGRAPH_SAMPLES // 400
    start = rng.uniform(-80, 80, (lines, 1, 2))
    angle = rng.uniform(-np.pi, np.pi, (lines, 1))
    direction = np.stack([np.cos(angle), np.sin(angle)], -1)
    xy = start + np.arange(per_line)[None, :, None] * 1.0 * direction
    road_types = np.array([1, 2, 3, 6, 7, 8, 9, 10, 11, 12, 13, 15, 16, 17,
                           18, 19])
    rg = lambda v: v.reshape(NUM_ROADGRAPH_SAMPLES, -1)  # noqa: E731
    s["roadgraph_samples/xyz"] = rg(np.concatenate(
        [xy, np.zeros((lines, per_line, 1))], -1)).astype(np.float32)
    s["roadgraph_samples/dir"] = rg(np.concatenate(
        [np.broadcast_to(direction, xy.shape), np.zeros((lines, per_line, 1))],
        -1)).astype(np.float32)
    s["roadgraph_samples/id"] = rg(np.repeat(np.arange(lines), per_line))
    s["roadgraph_samples/type"] = rg(np.repeat(
        road_types[np.arange(lines) % road_types.size], per_line))
    s["roadgraph_samples/valid"] = rg((rng.random((lines, per_line)) < 0.95
                                       ).astype(np.int64))
    return s


def differing(a: np.ndarray, b: np.ndarray) -> int:
    """Elements whose bits differ (NaN against NaN included)."""
    view = {1: np.uint8, 4: np.uint32, 8: np.uint64}[a.itemsize]
    return int((a.view(view) != b.view(view)).sum())


def preprocess_breakdown(proc, scenarios) -> None:
    """Where ``Processor.raster_features`` spends its time on the card: the
    seven renders of ``create_timestep_grids`` one by one on the first
    scenario (host clock, each synchronised), then ``torch.profiler`` over
    the whole call on two scenarios: the device's busy share of the window,
    its largest kernels and the host operators that took longest."""
    cfg, s = WAYMO_OGM_TASK_CONFIG, scenarios[0]
    steps = ["past", "current", "future"]
    occupancy = functools.partial(render_occupancy, s, config=cfg,
                                  device=proc.device)
    flow = functools.partial(render_backward_flow, s, config=cfg,
                             device=proc.device)
    renders = (
        ("current", lambda: occupancy(["current"])),
        ("past", lambda: occupancy(["past"])),
        ("history flow", lambda: flow(["past", "current"],
                                      waypoint_size=NUM_PAST_STEPS)),
        ("future observed", lambda: occupancy(["future"],
                                              include_occluded=False)),
        ("future occluded", lambda: occupancy(["future"],
                                              include_observed=False)),
        ("all occupancy", lambda: occupancy(steps)),
        ("all flow", lambda: flow(steps, waypoint_size=(
            cfg.num_future_steps // cfg.num_waypoints))),
    )
    split = []
    for name, fn in renders:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        split.append(f"{name} {(time.perf_counter() - t0) * 1e3:.2f}")
    print("preprocess renders, ms on the host clock: " + ", ".join(split))

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in scenarios[:2]:
            proc.raster_features(s)
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels and copies only: an operator's device time counts them again
    on_device = sorted(
        (e for e in events if e.device_time_total > 0 and
         e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: -e.device_time_total)
    busy_ms = sum(e.device_time_total for e in on_device) / 1e3
    print(f"preprocess profile, raster_features of 2 scenarios: window "
          f"{window_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / window_ms:.1f} %); largest on the device: "
          + "; ".join(f"{e.key[:60]} {e.device_time_total / 1e3:.2f} ms"
                      f" x{e.count}" for e in on_device[:6]))
    on_host = sorted(events, key=lambda e: -e.self_cpu_time_total)
    print("preprocess profile, host operators by self time: "
          + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} ms"
                      f" x{e.count}" for e in on_host[:8]))


def preprocess_phase() -> None:
    """The offline preprocessor's tensor and vector parts at the full WOMD
    geometry (TensorFlow and matplotlib, which read and write shards and
    draw the map, are not here): (i) the C library's sine and cosine and
    the fused multiply-add (``core/libm.py``) on the card against the CPU,
    over every path of the reduction; (ii) ``PREPROCESS_SCENARIOS``
    scenarios through ``Processor.raster_features`` on the card and on its
    CPU twin, every array equal (0 cells differ), ms a scenario of each
    after a warm-up (host clock, the copy to numpy included), scenarios/s
    and the card's peak memory; (iii) ``Processor.vector_features``
    against ``data/schema.py::SHAPES``. No kernel launches."""
    rng = np.random.default_rng(0)
    n = 1 << 20
    x = np.concatenate([
        rng.uniform(-8, 8, n), rng.uniform(-200, 200, n // 4),
        10.0 ** rng.uniform(-40, 38, n // 4) * rng.choice([-1, 1], n // 4),
    ]).astype(np.float32)
    xs = torch.from_numpy(x)
    for name, fn in (("sinf", sinf), ("cosf", cosf),
                     ("fmaf", lambda v: fmaf(v, v.flip(0), v.roll(1)))):
        bad = differing(fn(xs.cuda()).cpu().numpy(), fn(xs).numpy())
        print(f"preprocess: {name} on the card vs the CPU, {x.size} float32 "
              f"values: {bad} differ")
        check(bad == 0, f"{name}: {bad} values differ on the card")

    scenarios = [womd_scenario(seed) for seed in range(PREPROCESS_SCENARIOS)]
    card = Processor(device="cuda")
    host = Processor(device="cpu")
    reset_counters()
    card.raster_features(scenarios[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    grids, card_ms = [], []
    for s in scenarios:
        t0 = time.perf_counter()
        grids.append(card.raster_features(s))
        card_ms.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    check(read_counters() == counts(), "the preprocessor launched a kernel")
    host_ms, cells, bad = [], 0, 0
    for s, ours in zip(scenarios, grids):
        t0 = time.perf_counter()
        ref = host.raster_features(s)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        check(sorted(ours) == sorted(ref), "raster keys")
        for k in ref:
            check(ours[k].dtype == ref[k].dtype and
                  ours[k].shape == ref[k].shape, f"{k} dtype or shape")
            cells += ref[k].size
            bad += differing(ours[k], ref[k])
        check(ours["ogm"].any() and np.abs(ours["gt_flow"]).sum() > 0,
              "empty grids")
        check(ours["ogm"].shape == SHAPES["ogm"] and
              ours["gt_flow"].shape == SHAPES["gt_flow"], "raster shapes")
    mean_card = sum(card_ms) / len(card_ms)
    print(f"preprocess raster, {len(scenarios)} scenarios at 512^2 (128 "
          f"agents x 91 steps, 48x16 points a box): card "
          f"{mean_card:.2f} ms/scenario (each "
          f"{', '.join(f'{t:.2f}' for t in card_ms)}), "
          f"{1e3 / mean_card:.2f} scenarios/s, peak {peak_mb:.1f} MB; CPU "
          f"twin {sum(host_ms) / len(host_ms):.1f} ms/scenario; card vs CPU "
          f"{bad} of {cells} cells differ")
    check(bad == 0, f"preprocess: {bad} cells differ between card and CPU")

    preprocess_breakdown(card, scenarios)

    vector_ms = []
    for s in scenarios:
        t0 = time.perf_counter()
        vectors, _ = card.vector_features(s)
        vector_ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in vectors.items():
            check(v.shape == SHAPES[k] and v.dtype == np.float64 and
                  np.isfinite(v).all(), f"vector feature {k}")
        check(np.abs(vectors["actors"]).sum() > 0 and
              np.abs(vectors["centerlines"]).sum() > 0, "empty vectors")
    print(f"preprocess vectors (numpy): "
          f"{sum(vector_ms) / len(vector_ms):.1f} ms/scenario")


# The tools phase: the bench's repeats and iterations, the probe's
# combinations and rounds, the parts profile's iterations.
TOOLS_BENCH = dict(repeats=3, iters=5)
TOOLS_PROBE = dict(tails=("xla", "infer"), modes=("block", "attn"),
                   batches=(BATCH,), rounds=3)
TOOLS_PARTS_ITERS = 10
# Launches per call of each bench phase, and per forward of each probe mode
# and tail.
BENCH_LAUNCHES = {"forward": dict(k1=8), "train": dict(k1=8, k2=8, k5=1)}
PROBE_LAUNCHES = {"block": dict(k1=8), "attn": dict(k3=8),
                  "xla": {}, "infer": dict(k7=2)}
# sample and dense_image_warp, card against CPU, f32: the same operations
# in the same order, so only the last bit of a blend may differ.
SAMPLE_MAX_ABS = 1e-6


def check_spread(what: str, s: dict) -> None:
    vals = (s["min"], s["median"], s["max"])
    check(all(np.isfinite(v) for v in vals) and vals[0] <= vals[1] <= vals[2],
          f"{what}: min <= median <= max, all finite, got {vals}")


def check_sampling_on_card() -> None:
    """``sample``'s eight option combinations and ``dense_image_warp`` on
    the card against the CPU, f32, on seeded warps with out-of-range
    points and exact .5 ties."""
    g = torch.Generator().manual_seed(0)
    image = torch.rand(4, 64, 48, 3, generator=g)
    warp = torch.rand(4, 40, 30, 2, generator=g) * 80.0 - 10.0
    warp[:, ::3] = torch.round(warp[:, ::3]) + 0.5
    flow = torch.randn(4, 64, 48, 2, generator=g) * 6.0
    worst = 0.0
    for r in ResamplingType:
        for b in BorderType:
            for p in PixelType:
                cpu = sample(image, warp, r, b, p)
                card = sample(image.cuda(), warp.cuda(), r, b, p).cpu()
                check(card.shape == cpu.shape, f"sample {r} {b} {p} shape")
                worst = max(worst, float((card - cpu).abs().max()))
    err = float((dense_image_warp(image.cuda(), flow.cuda()).cpu()
                 - dense_image_warp(image, flow)).abs().max())
    print(f"sample, 8 option combinations, card vs CPU: max abs err {worst}; "
          f"dense_image_warp {err}")
    check(max(worst, err) <= SAMPLE_MAX_ABS,
          f"sample / dense_image_warp card vs CPU {max(worst, err)} <= "
          f"{SAMPLE_MAX_ABS}")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (a transposed convolution may
    otherwise sum with atomics), for the comparisons bit for bit."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def tools_phase():
    """The measuring tools on the card: the bench, the forward-mode probe,
    the parts profile and the graft entry; ``spatial_shard`` as the
    identity; ``sample``'s options and ``dense_image_warp``. Returns every
    launch of K1 .. K7 the phase made (the tools' warm-ups and the parts
    profile's runs included)."""
    t0 = time.perf_counter()
    reset_counters()
    result = bench.run(STRAJNET_CONFIG, "cuda", budget_s=600.0,
                       **TOOLS_BENCH)
    check(not result["skipped"], f"every bench phase ran: {result}")
    for name, line in result["phases"].items():
        check_spread(f"bench {name} ms", line["ms"])
        check_spread(f"bench {name} scenes/s", line["scenes_per_s"])
        check(0.0 < line["mfu"] <= 1.05, f"bench {name} mfu {line['mfu']}")
        per_call = BENCH_LAUNCHES[line["phase"]]
        want = {k: line["calls"] * per_call.get(k, 0) for k in COUNTERS}
        check(line["launches"] == want,
              f"bench {name} launches {line['launches']}, want {want}")
    check(result["phases"][f"train@{bench.TRAIN_BATCH}"]["loss_sum_finite"],
          "bench training losses finite")

    probe = probe_forward_modes.run(STRAJNET_CONFIG, "cuda", **TOOLS_PROBE)
    for key, row in probe.items():
        tail, mode, _ = key.split("/")
        check_spread(f"probe {key} ms", row["ms"])
        want = dict(k1=0, k3=0, k7=0)
        want.update(PROBE_LAUNCHES[mode])
        want.update(PROBE_LAUNCHES[tail])
        check(row["launches_per_forward"] == want,
              f"probe {key} launches {row['launches_per_forward']}, "
              f"want {want}")

    parts = profile_parts.run(STRAJNET_CONFIG, "cuda", BATCH,
                              TOOLS_PARTS_ITERS, profile_parts.COARSE)
    for part, row in parts.items():
        check(all(np.isfinite(row[k]) and row[k] > 0
                  for k in ("ms", "device_ms", "flops")),
              f"part {part}: {row}")

    state = init_params(STRAJNET_CONFIG, torch.Generator().manual_seed(0))
    with torch.inference_mode(), deterministic_cudnn():
        fn, args = graft_entry.entry()
        y_entry = fn(*args)
        model = bench.load_model(STRAJNET_CONFIG, state, "cuda")
        y_model = model(*args[1:])
        check(torch.equal(y_entry, y_model),
              "entry()'s forward equals STrajNet(STRAJNET_CONFIG)'s")
        del fn, args
        inputs = bench.model_inputs(STRAJNET_CONFIG, BATCH, "cuda")
        sharded = bench.load_model(
            dataclasses.replace(STRAJNET_CONFIG, spatial_shard=True), state,
            "cuda")
        y = model(**inputs)
        y_sharded = sharded(**inputs)
        check(torch.equal(y, y_sharded) and bool(torch.isfinite(y).all()),
              "the flagship forward with spatial_shard equals the one "
              "without")
    print(f"entry() forward {tuple(y_entry.shape)} equals the module's; "
          f"spatial_shard=True forward [{BATCH}, ...] equals the one without")
    del model, sharded, y, y_sharded, y_entry
    check_sampling_on_card()
    torch.cuda.empty_cache()
    launches = read_counters()
    print(f"tools phase: {time.perf_counter() - t0:.1f} s; launches K1-K7 "
          f"{launches}")
    return launches


def swin_block_count(model) -> int:
    return sum(isinstance(m, SwinTransformerBlock) for m in model.modules())


V2_COUNTERS = (v2.swinv2_block, v2.swinv2_block_bwd)


_V2_STAGE_BASE = [0]


def reset_v2_counters() -> None:
    for fn in V2_COUNTERS:
        fn.launches_any = 0
    _V2_STAGE_BASE[0] = window_any_v2_attn_launches()


def read_v2_counters() -> tuple:
    """The SwinV2 block's forward and backward calls and the fused attention
    stage's launches (one a call each way in bf16 at head size 32) since
    ``reset_v2_counters``."""
    return tuple(fn.launches_any for fn in V2_COUNTERS) + (
        window_any_v2_attn_launches() - _V2_STAGE_BASE[0],)


def widths_forward(name, cfg, plain_cfg, batch_size, expect_any, f32_rel,
                   expect=None, expect_v2=(0, 0, 0)):
    """One eval-mode forward of ``cfg`` through the kernels against
    ``plain_cfg`` on the same seed-0 weights and batch; times both in
    TIMING_ROUNDS rounds of turns. The kernel forward's launches: the
    general route's ``expect_any``, the wgmma route's ``expect`` (none by
    default), the SwinV2 block's forward and backward calls and fused
    attention stages ``expect_v2``. Returns the general route's launches of
    the kernel forward."""
    expect = counts() if expect is None else expect
    state = init_params(cfg, torch.Generator().manual_seed(0))
    model, plain = (bench.load_model(c, state, "cuda")
                    for c in (cfg, plain_cfg))
    inputs = bench.model_inputs(cfg, batch_size, "cuda")
    with torch.inference_mode():
        reset_counters()
        reset_v2_counters()
        y = model(**inputs)
        torch.cuda.synchronize()
        got_any, got = read_general_counters(), read_counters()
        got_v2 = read_v2_counters()
        y_plain = plain(**inputs)
        check(got_any == expect_any and got == expect
              and got_v2 == expect_v2,
              f"{name} forward: general launches {got_any} (want "
              f"{expect_any}), wgmma {got} (want {expect}), SwinV2 "
              f"{got_v2} (want {expect_v2})")
        check(bool(torch.isfinite(y).all()), f"{name} forward finite")
        err = float((y.float() - y_plain.float()).abs().max())
        scale = float(y_plain.float().abs().max())
        omc = one_minus_cos(y, y_plain)
        if f32_rel:
            check(err <= WIDTHS_F32_MAX_ABS_REL * scale,
                  f"{name} forward: max_abs_err {err} <= "
                  f"{WIDTHS_F32_MAX_ABS_REL} * {scale}")
        else:
            check(omc <= WIDTHS_ONE_MINUS_COS,
                  f"{name} forward: 1-cos {omc} <= {WIDTHS_ONE_MINUS_COS}")
        ks, ps = in_turns(plain, model,
                          lambda m: cuda_ms(lambda: m(**inputs), iters=2))
    print(f"widths {name} forward [{batch_size}, ...] {cfg.dtype}: "
          f"max_abs_err/max|plain|={err / scale:.3e}"
          + (f" (limit {WIDTHS_F32_MAX_ABS_REL})" if f32_rel else "")
          + f" 1-cos={omc:.3e}"
          + ("" if f32_rel else f" (limit {WIDTHS_ONE_MINUS_COS})")
          + f"; launches general K1-K4,K7 {got_any}, wgmma K1-K7 {got}, "
          f"SwinV2 {got_v2}; kernel path {fmt_spread(ks, 3)} ms, plain path "
          f"{fmt_spread(ps, 3)} ms (min / median / max of "
          f"{2 * TIMING_ROUNDS})")
    return got_any


def widths_step(name, cfg, plain_cfg, batch_size, expect_any, expect,
                expect_v2=(0, 0, 0), exact_cfg=None):
    """The first training step of ``cfg`` through the kernels against the
    plain path's from the same weights, batch and noise: loss and whole
    gradient; then the later steps of each, timed on the host's clock in
    TIMING_ROUNDS rounds of turns. With ``exact_cfg`` (the plain path in
    f32) the whole gradient is held against that step's instead, no further
    from it than V2_BF16_FACTOR times the plain path's (floor
    V2_BF16_COS_FLOOR), as the SwinV2 block's checks hold the block. The
    kernel step's launches: the general route's ``expect_any``, the wgmma
    route's ``expect``, the SwinV2 block's forward and backward calls and
    fused attention stages ``expect_v2``. Returns the general route's
    launches of the kernel step."""
    task = TaskConfig(grid_height_cells=cfg.output_size[0],
                      grid_width_cells=cfg.output_size[1],
                      num_waypoints=cfg.num_waypoints)
    batch = bench.train_batch(cfg, batch_size, "cuda")
    res, runs = {}, {}
    for which, c in (("kernel", cfg), ("plain", plain_cfg),
                     ("exact", exact_cfg)):
        if c is None:
            continue
        state = bench.train_state(c, batch_size, "cuda")
        step = make_train_step(task, LossConfig(), c.num_waypoints)
        noise = torch.Generator(device="cuda").manual_seed(0)
        reset_counters()
        reset_v2_counters()
        state, losses = step(state, batch, noise)
        torch.cuda.synchronize()
        launches = read_general_counters(), read_counters(), read_v2_counters()
        grads = torch.cat([p.grad.flatten().float()
                           for p in state.model.parameters()])
        res[which] = (float(losses["total"]), grads, launches)
        runs[which] = [step, state, noise]

    def step_ms(which):
        step, state, noise = runs[which]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[which][1] = step(state, batch, noise)[0]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    runs.pop("exact", None)
    ks, ps = in_turns("plain", "kernel", step_ms)
    del runs
    (loss, grads, (got_any, got, got_v2)), (ref_loss, ref_grads, _) = (
        res["kernel"], res["plain"])
    check(got_any == expect_any and got == expect and got_v2 == expect_v2,
          f"{name} step: general launches {got_any} (want {expect_any}), "
          f"wgmma {got} (want {expect}), SwinV2 {got_v2} (want "
          f"{expect_v2})")
    check(bool(np.isfinite(loss)) and bool(torch.isfinite(grads).all()),
          f"{name} step: loss and gradients finite")
    omc, limit, against = (one_minus_cos(grads, ref_grads),
                           WIDTHS_GRAD_ONE_MINUS_COS, "plain")
    if exact_cfg is not None:
        exact_grads = res["exact"][1]
        omc_plain = one_minus_cos(ref_grads, exact_grads)
        omc, limit = (one_minus_cos(grads, exact_grads),
                      max(V2_BF16_FACTOR * omc_plain, V2_BF16_COS_FLOOR))
        against = (f"f32 plain, the plain path's {omc_plain:.3e}, kernels "
                   f"against plain {one_minus_cos(grads, ref_grads):.3e}")
    print(f"widths {name} step [{batch_size}, ...]: total loss {loss:.6f} "
          f"vs plain {ref_loss:.6f} (limit {WIDTHS_LOSS_RTOL} relative); "
          f"gradient 1-cos={omc:.3e} against {against} (limit "
          f"{limit:.3e}); "
          f"launches general K1-K4,K7 {got_any}, wgmma K1-K7 {got}, SwinV2 "
          f"{got_v2}; later steps {fmt_spread(ks, 1)} ms, plain "
          f"{fmt_spread(ps, 1)} ms (min "
          f"/ median / max of {2 * TIMING_ROUNDS}, host clock)")
    check(abs(loss - ref_loss) <= WIDTHS_LOSS_RTOL * abs(ref_loss),
          f"{name} step: loss {loss} within {WIDTHS_LOSS_RTOL} of {ref_loss}")
    check(omc <= limit, f"{name} step: gradient 1-cos {omc} <= {limit}")
    return got_any


def widths_phase() -> tuple:
    """Whole models whose Swin blocks or tails the wgmma kernels are not
    built for, with the kernels on against the plain path
    (``use_pallas_attention=False``, the naive tail): the flagship in f32
    (forward, batch 2), the Swin-B width in bf16 (forward and a step, batch
    4), TINY in the ``"block"`` and ``"attn"`` modes with the tail kernel
    (forward and a step each, batch 4), the SwinV2-B preset (forward and a
    step, batch 2: its 26 blocks on the SwinV2 route, no Swin-v1 block, the
    wgmma K7 in the forward's two tails; the step's gradient held against
    the plain path's in f32). Returns the general route's
    launches of K1-K4 and K7 and the SwinV2 block's forward and backward
    calls over these runs."""
    t0 = time.perf_counter()
    total = [0] * len(GENERAL_COUNTERS)

    def add(launches):
        for i, n in enumerate(launches):
            total[i] += n

    general = functools.partial(counts, GENERAL_COUNTERS)
    plain = dict(use_pallas_attention=False, use_pallas_decoder_tail=False)
    f32 = dataclasses.replace(STRAJNET_CONFIG, dtype="float32")
    blocks = swin_block_count(STrajNet(f32))
    add(widths_forward("flagship f32", f32,
                       dataclasses.replace(f32, **plain), 2,
                       general(k1=blocks), True))
    torch.cuda.empty_cache()
    blocks = swin_block_count(STrajNet(SWIN_B_CONFIG))
    swin_b_plain = dataclasses.replace(SWIN_B_CONFIG, **plain)
    add(widths_forward("Swin-B width", SWIN_B_CONFIG, swin_b_plain, 4,
                       general(k1=blocks), False))
    add(widths_step("Swin-B width", SWIN_B_CONFIG, swin_b_plain, 4,
                    general(k1=blocks, k2=blocks), counts(k5=1)))
    torch.cuda.empty_cache()
    blocks = swin_block_count(STrajNet(TINY_MODEL_CONFIG))
    tiny_plain = dataclasses.replace(TINY_MODEL_CONFIG, **plain)
    for mode, fwd, bwd in (("block", "k1", "k2"), ("attn", "k3", "k4")):
        cfg = dataclasses.replace(TINY_MODEL_CONFIG,
                                  use_pallas_attention=mode,
                                  use_pallas_decoder_tail=True)
        name = f"TINY {mode!r} + tail kernel"
        add(widths_forward(name, cfg, tiny_plain, 4,
                           general(**{fwd: blocks}, k7=2), False))
        add(widths_step(name, cfg, tiny_plain, 4,
                        general(**{fwd: blocks, bwd: blocks}, k7=2),
                        counts(k5=1)))
    torch.cuda.empty_cache()
    v2_cfg = STRAJNET_SWINV2_B_CONFIG
    blocks = sum(isinstance(m, SwinV2TransformerBlock)
                 for m in STrajNet(v2_cfg).modules())
    check(blocks == 26, f"SwinV2-B has 26 SwinV2 blocks, got {blocks}")
    v2_plain = dataclasses.replace(v2_cfg, **plain)
    add(widths_forward("SwinV2-B", v2_cfg, v2_plain, 2, general(), False,
                       counts(k7=2), (blocks, 0, blocks)))
    add(widths_step("SwinV2-B", v2_cfg, v2_plain, 2, general(), counts(k5=1),
                    (blocks, blocks, 2 * blocks),
                    dataclasses.replace(v2_plain, dtype="float32")))
    total += [2 * blocks, blocks]   # the forward's and the step's
    torch.cuda.empty_cache()
    check_swinv2_attention_stage(
        torch.Generator(device="cuda").manual_seed(24))
    print(f"widths phase: {time.perf_counter() - t0:.1f} s; general "
          f"launches K1-K4,K7 {tuple(total[:-2])}, SwinV2 forward and "
          f"backward calls {tuple(total[-2:])}")
    return tuple(total)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--ddp-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--ddp-dir", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--tp-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--tp-dir", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.ddp_rank is not None or args.tp_rank is not None:
        # one of the ddp or tp phase's rank processes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if args.ddp_rank is not None:
            ddp_rank(args.ddp_rank, args.ddp_dir)
        else:
            tp_rank(args.tp_rank, args.tp_dir)
        return 0
    phases = tuple(args.phases.split(","))
    if set(phases) - set(PHASES):
        parser.error(f"unknown phases {set(phases) - set(PHASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_identity()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    t0 = time.perf_counter()
    builds = _build.build_all(KERNEL_SOURCES)
    print(f"nvcc build of {len(builds)} sources in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for name, build in builds.items():
        print(f"  {name}: {build.seconds:.2f} s"
              + (" (up-to-date build found)" if build.seconds == 0 else ""))
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())

    csrc, jax_ops = "strajnet_tpu_torch/csrc/", "strajnet_tpu/ops/"
    kernels = {   # K1 .. K7, in the order of COUNTERS
        "swin_block": dict(
            source=csrc + "swin_block.cu",
            replaces=jax_ops + "pallas_swin_block.py:82"),
        "swin_block_bwd": dict(
            source=csrc + "swin_block_bwd.cu",
            replaces=jax_ops + "pallas_swin_block.py:143"),
        "window_attention": dict(
            source=csrc + "window_attention.cu",
            replaces=jax_ops + "pallas_window_attention.py:91"),
        "window_attention_bwd": dict(
            source=csrc + "window_attention.cu",
            replaces=jax_ops + "pallas_window_attention.py:131"),
        "warp_gather_fwd": dict(
            source=csrc + "warp_gather.cu",
            replaces=jax_ops + "pallas_warp_gather.py:57"),
        "warp_gather_bwd": dict(
            source=csrc + "warp_gather.cu",
            replaces=jax_ops + "pallas_warp_gather.py:83"),
        "decoder_tail": dict(
            source=csrc + "decoder_tail.cu",
            replaces=jax_ops + "pallas_decoder_tail.py:127"),
    }
    # the general route of K1-K4 and K7, in the order of GENERAL_COUNTERS
    general = {
        "swin_block_any": dict(
            source=csrc + "window_any.cu",
            replaces=jax_ops + "pallas_swin_block.py:82"),
        "swin_block_bwd_any": dict(
            source=csrc + "window_any.cu",
            replaces=jax_ops + "pallas_swin_block.py:143"),
        "window_attention_any": dict(
            source=csrc + "window_any.cu",
            replaces=jax_ops + "pallas_window_attention.py:91"),
        "window_attention_bwd_any": dict(
            source=csrc + "window_any.cu",
            replaces=jax_ops + "pallas_window_attention.py:131"),
        "decoder_tail_any": dict(
            source=csrc + "decoder_tail_any.cu",
            replaces=jax_ops + "pallas_decoder_tail.py:127"),
    }
    # the SwinV2 block's forward and backward on the general route
    swinv2 = {
        "swinv2_block_any": dict(source=csrc + "window_any.cu",
                                 replaces=None),
        "swinv2_block_bwd_any": dict(source=csrc + "window_any.cu",
                                     replaces=None),
    }
    launches = dict.fromkeys(list(kernels) + list(general) + list(swinv2),
                             0)

    def add_launches(counters, names=tuple(kernels)):
        for name, count in zip(names, counters):
            launches[name] += count

    g = torch.Generator(device="cuda").manual_seed(0)
    if "kernels" in phases:
        reset_counters()
        kernels["swin_block"].update(check_swin_block(g))
        kernels["swin_block_bwd"].update(check_swin_block_bwd(g))
        kernels["swin_block_bwd"]["split_k"] = check_split_k(g)
        check_ragged_and_repeat(g)
        for name, source, kernel in (
                ("swin_block", "swin_block", "swin_block_fwd_kernel"),
                ("swin_block_bwd", "swin_block_bwd",
                 "swin_block_bwd_window_kernel")):
            res = kernel_resources(builds[source].log, kernel)
            kernels[name]["regs"] = {str(c): r for c, (r, _) in res.items()}
            kernels[name]["spill_bytes"] = {str(c): sp
                                            for c, (_, sp) in res.items()}
            kernels[name]["smem_bytes"] = {
                str(c): kernel_smem_bytes(c, 4 * c)[name == "swin_block_bwd"]
                for c in (96, 192, 384)}
        k3, k4 = check_window_attention(g)
        kernels["window_attention"].update(k3)
        kernels["window_attention_bwd"].update(k4)
        check_attention_ragged_and_repeat(g)
        for name, kernel, smem in (
                ("window_attention", "window_attention_fwd_kernel",
                 wa.fwd_kernel_smem_bytes),
                ("window_attention_bwd", "window_attention_bwd_kernel",
                 wa.bwd_kernel_smem_bytes)):
            res = kernel_resources(builds["window_attention"].log, kernel)
            kernels[name].update(
                regs={str(c): r for c, (r, _) in res.items()},
                spill_bytes={str(c): sp for c, (_, sp) in res.items()},
                smem_bytes={str(c): smem(c) for c in (96, 192, 384)})
        k5, k6 = check_warp_gather(g)
        kernels["warp_gather_fwd"].update(k5)
        kernels["warp_gather_bwd"].update(k6)
        regs, spill = kernel_resources(builds["warp_gather"].log,
                                       "warp_gather_bwd_kernel")[0]
        kernels["warp_gather_bwd"].update(regs=regs, spill_bytes=spill)
        kernels["decoder_tail"].update(check_decoder_tail(g))
        regs, spill = kernel_resources(builds["decoder_tail"].log,
                                       "decoder_tail_kernel")[0]
        kernels["decoder_tail"].update(
            regs=regs, spill_bytes=spill,
            smem_bytes=dtl.kernel_smem_bytes())
        check(read_general_counters() == counts(GENERAL_COUNTERS),
              f"the wgmma route's checks launched no general kernel, got "
              f"{read_general_counters()}")
        torch.cuda.empty_cache()
        for name, res in zip(general, tuple(check_general_kernels(g).values())
                             + (check_general_tail(g),)):
            general[name].update(res)
        general_breakdown(g)
        swinv2["swinv2_block_any"].update(check_swinv2_block(g))
        swinv2["swinv2_block_bwd_any"].update(check_swinv2_block_bwd(g))
        general["swin_block_any"]["resources"] = {
            window_any_label(n): list(r)
            for n, r in build_resources(builds["window_any"].log).items()}
        print(f"window_any.cu kernels [registers, static shared bytes, "
              f"spill bytes]: {general['swin_block_any']['resources']}")
        general["decoder_tail_any"]["resources"] = {
            window_any_label(n, DECODER_TAIL_ANY_KERNELS): list(r)
            for n, r in build_resources(
                builds["decoder_tail_any"].log).items()}
        print(f"decoder_tail_any.cu kernels [registers, static shared "
              f"bytes, spill bytes]: "
              f"{general['decoder_tail_any']['resources']}")
        torch.cuda.empty_cache()
    if set(phases) & {"forward", "serve", "eval"}:
        state = init_params(STRAJNET_CONFIG, torch.Generator().manual_seed(0))
        if "forward" in phases or "serve" in phases:
            model = check_forward(state)
            if "serve" in phases:
                add_launches(serve(model))
            del model
            torch.cuda.empty_cache()
        if "eval" in phases:
            add_launches(eval_path(state))
            torch.cuda.empty_cache()
        del state
    if "train" in phases:
        add_launches(train_steps())
        add_launches(warp_gradient_path())
    if "loop" in phases:
        add_launches(loop_phase())
    if "variants" in phases:
        add_launches(variants_phase())
    if "ddp" in phases:
        add_launches(ddp_phase())
    if "tp" in phases:
        add_launches(tp_phase())
    if "preprocess" in phases:
        preprocess_phase()
    if "tools" in phases:
        add_launches(tools_phase())
    if "widths" in phases:
        add_launches(widths_phase(), tuple(general) + tuple(swinv2))

    print(smi)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", launches=launches[name], **info)
        for name, info in list(kernels.items()) + list(general.items())
        + list(swinv2.items())]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
