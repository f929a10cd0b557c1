"""Typed configuration tree for the whole framework.

The reference spreads configuration over three mechanisms (argparse CLIs,
an ``OccupancyFlowTaskConfig`` proto parsed from inline text, and python
dicts/ctor kwargs — see reference train.py:28-54,183-197). Here everything is
one dataclass tree; the proto *text format* is kept as an import/export format
for challenge fidelity (``TaskConfig.from_text`` / ``.to_text``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class TaskConfig:
    """Occupancy-flow task geometry.

    Field-compatible with the Waymo ``OccupancyFlowTaskConfig`` proto used by
    the reference (train.py:28-43; duplicated at inference.py:41-56 and
    data_preprocessing.py:66-101).
    """

    num_past_steps: int = 10
    num_future_steps: int = 80
    num_waypoints: int = 8
    cumulative_waypoints: bool = False
    normalize_sdc_yaw: bool = True
    grid_height_cells: int = 256
    grid_width_cells: int = 256
    sdc_y_in_grid: int = 192
    sdc_x_in_grid: int = 128
    pixels_per_meter: float = 3.2
    agent_points_per_side_length: int = 48
    agent_points_per_side_width: int = 16

    @classmethod
    def from_text(cls, text: str) -> "TaskConfig":
        """Parses a proto-text block of ``key: value`` lines (challenge format)."""
        kwargs = {}
        valid = {f.name: f.type for f in dataclasses.fields(cls)}
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            key, _, value = line.partition(":")
            key, value = key.strip(), value.strip()
            if key not in valid:
                raise ValueError(f"unknown TaskConfig field: {key!r}")
            if value in ("true", "false", "True", "False"):
                kwargs[key] = value.lower() == "true"
            elif "." in value or "e" in value.lower():
                kwargs[key] = float(value)
            else:
                kwargs[key] = int(value)
        return cls(**kwargs)

    def to_text(self) -> str:
        lines = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, bool):
                v = "true" if v else "false"
            lines.append(f"{f.name}: {v}")
        return "\n".join(lines) + "\n"


# The challenge geometry used by the reference's model/GT grids
# (reference train.py:29-42): 256x256 grid at 3.2 px/m, SDC at (128, 192).
WAYMO_TASK_CONFIG = TaskConfig()

# The 512x512 OGM-history variant used in offline preprocessing
# (reference data_preprocessing.py:84-101): SDC at (256, 320).
WAYMO_OGM_TASK_CONFIG = TaskConfig(
    grid_height_cells=512,
    grid_width_cells=512,
    sdc_y_in_grid=320,
    sdc_x_in_grid=256,
)


@dataclass(frozen=True)
class ModelConfig:
    """STrajNet architecture config.

    Defaults follow the paper/headline variant: the training entry point of
    the reference leaves ``fg_msa=fg=False`` (reference modules.py:778-779,
    train.py:194) while its module smoke test and the paper enable both
    (modules.py:851). We default to the paper variant and expose the flags.
    """

    # Swin encoder (reference train.py:183)
    input_size: Tuple[int, int] = (512, 512)
    patch_size: int = 4
    window_size: int = 8
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    ape: bool = False
    patch_norm: bool = True
    # Encoder wiring (reference modules.py:782-785)
    sep_encode: bool = True
    flow_sep: bool = True
    use_flow: bool = True
    no_map: bool = False
    large_input: bool = True  # 512^2 OGM/flow with 256^2 map raster

    # OGM input
    ogm_past_steps: int = 11  # 10 past + 1 current
    ogm_classes: int = 2      # vehicles, ped+cyclists

    # Trajectory fusion (reference modules.py:788-795)
    actor_only: bool = True
    sep_actors: bool = False
    traj_heads: int = 4
    att_heads: int = 6
    traj_out_dim: int = 384
    obs_actors: int = 48
    occ_actors: int = 16
    actor_steps: int = 11
    actor_feats: int = 8      # 5 kinematic + 3 one-hot type
    map_segments: int = 256
    map_points: int = 10
    map_feats: int = 7        # 4 geometry + 3 one-hot type

    # Flow-guided deformable attention (reference modules.py:796-799)
    fg_msa: bool = True
    fg: bool = True
    fgmsa_heads: int = 8
    fgmsa_head_channels: int = 48
    fgmsa_groups: int = 8
    # Reference quirk (FG_MSA.py:142): the deformably-sampled K/V features are
    # overwritten by the identity-grid features. ``deform_kv=False`` replicates
    # that behavior; True uses the actually-sampled features.
    deform_kv: bool = False

    # Decoder (reference modules.py:800-801)
    use_pyramid: bool = True
    flow_sep_decode: bool = True
    conv_cnn: bool = False
    # ConvLSTM first stage of the separate flow head (reference
    # modules.py:681-684 ``sep_conv`` — dead in the training config but a
    # selectable variant).
    sep_conv: bool = False
    rep_res: bool = True
    stp_grad: bool = False

    # Task/waypoints
    num_waypoints: int = 8

    # Precision: compute dtype for the network ("bfloat16" | "float32").
    dtype: str = "bfloat16"

    # Swin-block kernel mode. The field names are the JAX package's, so that
    # one config describes both packages; models/strajnet.py resolves them.
    #   None, True or "block" -> the fused Swin-block kernel, forward and
    #                            backward (the plain version on CPU tensors)
    #   "block_fwd" -> kernel forward, autograd of the plain version backward
    #   False       -> the plain version everywhere
    #   "attn"      -> the window-attention kernel only, forward and
    #                  backward; LayerNorm, MLP and residuals in plain torch
    use_pallas_attention: Optional[Union[bool, str]] = None

    # Strip width and samples per program of the JAX package's kernels.
    # The CUDA kernels take one window per thread block and ignore both.
    pallas_windows_per_program: Union[int, Tuple[int, ...], None] = None
    pallas_samples_per_program: Optional[int] = None

    # Rematerialize encoder Swin blocks in the backward. The fused block
    # saves no activations (its backward kernel recomputes), so this only
    # concerns the plain path.
    remat_encoder: bool = False

    # Spatial activation partitioning over a device mesh (not ported).
    spatial_shard: bool = False

    # Decoder-tail formulation: None/False/"xla" = upconv, elu, conv as
    # separate ops; "phase" = the same in the phase domain, plain torch;
    # True/"kernel" = the fused decoder-tail kernel (the naive composition
    # on CPU tensors); "infer" = the kernel in eval() mode only.
    use_pallas_decoder_tail: Any = None

    # The Swin blocks' kind: "swin" (Swin-v1: pre-norm, scaled dot-product
    # attention, a relative-position table) or "swinv2" (SwinV2: post-norm
    # residuals, scaled cosine attention with a learned logit scale per
    # head, a continuous position bias from a small MLP, q and v biases
    # only, patch merging that reduces before it normalises). The port's
    # own field (the JAX package has no SwinV2): it comes after the JAX
    # package's fields, which it leaves as they are.
    block: str = "swin"

    @property
    def shallow_decode(self) -> int:
        return 4 - len(self.depths)

    @property
    def patches_resolution(self) -> Tuple[int, int]:
        return (self.input_size[0] // self.patch_size,
                self.input_size[1] // self.patch_size)

    @property
    def map_size(self) -> Tuple[int, int]:
        if self.large_input:
            return (self.input_size[0] // 2, self.input_size[1] // 2)
        return self.input_size

    @property
    def bottleneck_size(self) -> Tuple[int, int]:
        """Spatial size of the encoder bottleneck fed to FG-MSA / cross-attn."""
        p = self.patches_resolution[0] // (2 ** (len(self.depths) - 1))
        return (p // 2, p // 2) if self.large_input else (p, p)

    @property
    def bottleneck_dim(self) -> int:
        return self.embed_dim * (2 ** (len(self.depths) - 1))

    @property
    def output_size(self) -> Tuple[int, int]:
        """Spatial size of the decoded occupancy/flow grids."""
        h, w = self.bottleneck_size
        ups = 5 - self.shallow_decode  # number of 2x upsamplings in the decoder
        return (h * (2 ** ups), w * (2 ** ups))


# Standard Swin variant table (reference modules.py:8-15 `CFGS`; unused by
# STrajNet itself but part of the component inventory).
SWIN_VARIANTS = {
    "swin_tiny_224": dict(input_size=(224, 224), window_size=7,
                          embed_dim=96, depths=(2, 2, 6, 2),
                          num_heads=(3, 6, 12, 24)),
    "swin_small_224": dict(input_size=(224, 224), window_size=7,
                           embed_dim=96, depths=(2, 2, 18, 2),
                           num_heads=(3, 6, 12, 24)),
    "swin_base_224": dict(input_size=(224, 224), window_size=7,
                          embed_dim=128, depths=(2, 2, 18, 2),
                          num_heads=(4, 8, 16, 32)),
    "swin_base_384": dict(input_size=(384, 384), window_size=12,
                          embed_dim=128, depths=(2, 2, 18, 2),
                          num_heads=(4, 8, 16, 32)),
    "swin_large_224": dict(input_size=(224, 224), window_size=7,
                           embed_dim=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48)),
    "swin_large_384": dict(input_size=(384, 384), window_size=12,
                           embed_dim=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48)),
}

# Tiny configuration for fast tests / multi-chip dry runs.
TINY_MODEL_CONFIG = ModelConfig(
    input_size=(64, 64),
    window_size=4,
    embed_dim=16,
    depths=(2, 2, 2),
    num_heads=(1, 2, 4),
    traj_out_dim=64,
    traj_heads=2,
    att_heads=2,
    obs_actors=6,
    occ_actors=2,
    map_segments=8,
    fgmsa_heads=8,
    fgmsa_head_channels=8,
    fgmsa_groups=8,
    dtype="float32",
)

# Even smaller: for gradient/train-step tests on the CPU.
ULTRA_TINY_MODEL_CONFIG = ModelConfig(
    input_size=(32, 32),
    window_size=4,
    embed_dim=8,
    depths=(1, 1, 1),
    num_heads=(1, 2, 4),
    mlp_ratio=2.0,
    drop_path_rate=0.0,
    traj_out_dim=32,
    traj_heads=1,
    att_heads=1,
    obs_actors=4,
    occ_actors=2,
    map_segments=4,
    fgmsa_heads=8,
    fgmsa_head_channels=4,
    fgmsa_groups=8,
    dtype="float32",
)

# The paper/training configuration (reference train.py:183 + fg_msa on).
STRAJNET_CONFIG = ModelConfig()

# The exact checked-in training variant (fg_msa off, reference train.py:194).
STRAJNET_TRAIN_PY_CONFIG = ModelConfig(fg_msa=False, fg=False)

# The fields of ModelConfig that the JAX package's copy does not have.
PORT_ONLY_MODEL_FIELDS = ("block",)

# STrajNet on a SwinV2-B encoder (arXiv 2111.09883; microsoft/Swin-Transformer
# configs/swinv2/swinv2_base_patch4_window16_256.yaml: embed 128, depths
# (2, 2, 18, 2), heads (4, 8, 16, 32), window 16, MLP ratio 4, patch 4) in
# place of the paper's 3-stage Swin-v1 encoder, in bf16. Not SwinV2's own:
# FG-MSA's head width scaled to the 1024-wide bottleneck (8 heads x 128),
# the paper's 384-wide actors and STrajNet's drop-path rate 0.1. The port
# alone runs it (no JAX counterpart, no Flax import).
STRAJNET_SWINV2_B_CONFIG = ModelConfig(
    block="swinv2",
    embed_dim=128,
    depths=(2, 2, 18, 2),
    num_heads=(4, 8, 16, 32),
    window_size=16,
    mlp_ratio=4.0,
    fgmsa_heads=8,
    fgmsa_head_channels=128,
    fgmsa_groups=8,
    traj_out_dim=384,
    drop_path_rate=0.1,
    dtype="bfloat16",
    use_pallas_decoder_tail="infer",
)


@dataclass(frozen=True)
class LossConfig:
    """Objective weights & flags (reference train.py:188-196, loss.py:22-45)."""

    ogm_weight: float = 1000.0
    occ_weight: float = 1000.0
    flow_weight: float = 1.0
    flow_origin_weight: float = 1000.0
    no_use_warp: bool = False
    use_pred: bool = False
    use_focal_loss: bool = False
    use_gt: bool = True
    # Deviation flag (NOT reference behavior): feed the warp-loss occupancy
    # multiplier from the *predicted* logits even when ``use_pred=False``.
    # The reference (loss.py:156-158) uses the TRUE occupancies there, so warp
    # gradients flow only through pred_flow; enabling this routes warp
    # gradients into the occupancy heads as well. See PARITY.md.
    warp_pred_logits: bool = False
    # Route flow_warp_origin through the warp-gather kernel
    # (ops/warp_gather.py; numerics identical to core/sampling.sample).
    warp_kernel: bool = True


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    epochs: int = 15
    lr: float = 1e-4
    # Reference builds this schedule but never wires it (train.py:185-186,197).
    # We wire it by default; set use_schedule=False for constant-LR parity.
    use_schedule: bool = True
    first_decay_steps: int = int(30438 * 1.5)
    t_mul: float = 1.25
    m_mul: float = 0.99
    alpha: float = 0.0
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    save_dir: str = "./checkpoints"
    file_dir: str = "./Waymo_Dataset/preprocessed_data"
    shuffle_buffer: int = 2048  # reference uses 64 (train.py:381) — too small
    seed: int = 0
    # Feed uint8 grids / f16 map from the host pipeline (bit-exact 2.3x
    # fewer host->device bytes; the steps cast back to f32 on the device:
    # data/schema.py, train/step.py::ensure_f32).
    compact_feed: bool = True
