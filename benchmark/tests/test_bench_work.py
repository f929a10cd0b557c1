"""The frozen work counts of benchmark/work.py against PyTorch's
FlopCounterMode on the plain reference at TINY's widths, and the
meta-device count of a step against the same count on real tensors."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import pool as pools, weights, work
from benchmark.flops import step_flops
from benchmark.reference import model as ref_model
from benchmark.reference.prec import EXACT
from benchmark.tests.conftest import port_config, tiny_model


def _tiny_params(model):
    from strajnet_tpu_torch.models.strajnet import STrajNet
    spec = weights.spec_of(STrajNet(port_config(model)).state_dict())
    return spec, weights.draw(spec, 3, "cpu", ref_model.LEAF_RULES)


def test_swin_counts_equal_the_reference_blocks():
    model = tiny_model(dtype="float32")
    _, p = _tiny_params(model)
    batch = 3
    names = ["encoder.flow_layer"] + [f"encoder.layers{i}" for i in range(3)]
    fwd = bwd = 0
    for blk, j in zip(work.swin_blocks(model), range(8)):
        pre = f"{names[j // 2]}.blocks{j % 2}"
        x = torch.randn(batch, blk["side"] ** 2, blk["c"],
                        requires_grad=True)
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()
                  if k.startswith(pre + ".")}
        with FlopCounterMode(display=False) as c:
            y = ref_model.swin_block(EXACT, leaves, pre, x,
                                     (blk["side"],) * 2, blk["heads"],
                                     blk["ws"], blk["ws"] // 2 * blk["shift"],
                                     None)
        fwd += c.get_total_flops()
        with FlopCounterMode(display=False) as c:
            torch.autograd.grad(y.sum(), [x] + list(leaves.values()))
        bwd += c.get_total_flops()
    assert work.swin_work(model, batch, False)[0] == fwd
    assert work.swin_work(model, batch, True)[0] == bwd == 2 * fwd


def test_tail_count_is_the_reference_tails():
    """Four taps per upsampled pixel (the phase form the reference
    computes), nine for the output convolution; both tails of a batch."""
    model = tiny_model(dtype="float32")
    _, p = _tiny_params(model)
    batch, side = 2, pools.with_sizes(model)["output_size"] // 2
    x = torch.randn(batch, model["num_waypoints"], side, side, 96)
    with FlopCounterMode(display=False) as c:
        ref_model.tail(EXACT, p, "decoder.upconv_0_0", "decoder.outconv", x)
        ref_model.tail(EXACT, p, "decoder.upconvf_0_0", "decoder.outconv_f",
                       x)
    assert work.tails_work(model, batch)[0] == c.get_total_flops()
    n = batch * model["num_waypoints"]
    assert work.tail_work(n, side, side, 96, 48, 2, 4)[0] * 2 == \
        c.get_total_flops()


def test_step_count_on_meta_equals_real_tensors():
    model = tiny_model(dtype="float32")
    spec, p = _tiny_params(model)
    cfg = pools.with_sizes(model)
    batch = pools.make_pool(cfg, 2, 1, 4, "cpu", train=False)[0]
    with FlopCounterMode(display=False) as c:
        ref_model.forward(p, model, batch)
    assert step_flops(ref_model, model, spec, 2, False) == \
        c.get_total_flops()
    assert step_flops(ref_model, model, spec, 2, True) > \
        2.5 * c.get_total_flops()
