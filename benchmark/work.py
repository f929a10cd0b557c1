"""The work a layer needs, from its shapes alone, and the card's peaks.

The counts are the same whatever route implements the layer: they are what
the layer's mathematics needs, not what a kernel chooses to do (a backward
that recomputes its forward does more; that is the kernel's choice). A
floating-point operation is counted twice per multiply-add. Bytes count
each input read once and each output written once.

- Swin block forward, per token: ``8 C^2`` for the qkv and output
  projections, ``4 C hidden`` for the MLP, ``4 n C`` for the two attention
  products over windows of ``n`` tokens. Bytes: the activation in and out in
  the element type, the four weight matrices in it, the rel-pos bias and
  the shift mask in float32, the drop-path multipliers.
- Swin block backward: twice the forward's products (each product has two
  gradients). Bytes: x and dy in, dx out in the element type, the weights
  in it, the bias and mask, and every parameter's gradient written in
  float32.
- Decoder tail (upsample 2x, 3x3 conv, elu, 3x3 conv to two channels) in its
  phase form: 4 taps per upsampled pixel for the first convolution (the
  upsampled image's 3x3 taps fold onto 2x2 input taps), 9 for the second.
  Bytes: the input in, the two-channel output out, the weights.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.pool import with_sizes

# One H100 SXM at its full 700 W: dense bf16 tensor-core rate and HBM rate.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take for this work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def swin_blocks(cfg: dict) -> List[Dict[str, int]]:
    """The geometry of each Swin block of the encoder, in order: the flow
    stage's blocks and then each stage's."""
    pr = cfg["input_size"][0] // cfg["patch_size"]
    out = []
    stages = [0] + list(range(len(cfg["depths"])))
    for i in stages:
        side = pr // 2 ** i
        ws = min(cfg["window_size"], side)
        c = cfg["embed_dim"] * 2 ** i
        for j in range(cfg["depths"][i]):
            out.append(dict(side=side, c=c, heads=cfg["num_heads"][i], ws=ws,
                            hidden=int(c * cfg["mlp_ratio"]),
                            shift=int(j % 2 == 1 and side > ws)))
    return out


def swin_block_work(blk: Dict[str, int], batch: int, elt: int,
                    backward: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of one block's forward or backward."""
    side, c, hidden = blk["side"], blk["c"], blk["hidden"]
    n, heads = blk["ws"] ** 2, blk["heads"]
    tokens = batch * side * side
    flops = tokens * (8 * c * c + 4 * c * hidden + 4 * n * c)
    weights = 4 * c * c + 2 * c * hidden
    small = heads * n * n * 4 + batch * 2 * 4
    if blk["shift"]:
        small += (side // blk["ws"]) ** 2 * n * n * 4
    if not backward:
        return flops, tokens * c * elt * 2 + weights * elt + small
    grads = (weights + 9 * c + hidden + heads * n * n) * 4
    return 2 * flops, tokens * c * elt * 3 + weights * elt + small + grads


def swin_work(cfg: dict, batch: int, backward: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of all the encoder's Swin blocks, forward or
    backward."""
    elt = 2 if cfg["dtype"] == "bfloat16" else 4
    parts = [swin_block_work(b, batch, elt, backward)
             for b in swin_blocks(cfg)]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def tail_work(n: int, h: int, w: int, cin: int, cmid: int, cout: int,
              elt: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decoder tail on ``[n, h, w, cin]``."""
    pixels = n * 4 * h * w
    flops = 2 * pixels * (4 * cin * cmid + 9 * cmid * cout)
    nbytes = (n * h * w * cin * elt + pixels * cout * elt
              + (9 * cin * cmid + cmid + 9 * cmid * cout + cout) * 4)
    return flops, nbytes


def tails_work(cfg: dict, batch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the decoder's two tails (occupancy and flow), each
    over the waypoints of the batch: 96 -> 48 -> 2 channels at the output
    grid."""
    elt = 2 if cfg["dtype"] == "bfloat16" else 4
    side = with_sizes(cfg)["output_size"] // 2
    f, b = tail_work(batch * cfg["num_waypoints"], side, side, 96, 48, 2, elt)
    return 2 * f, 2 * b
