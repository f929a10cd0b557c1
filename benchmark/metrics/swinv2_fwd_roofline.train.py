"""swinv2_fwd_roofline.train: the encoder's SwinV2 blocks, forward: the least
time of their work (benchmark/work.py::swin_work, the same products and
attention as a Swin-v1 block's at the same widths) over the device time of
the kernels launched inside the program's ``_SwinV2BlockFn`` forwards, per
step. The work leaves out the normalisation of q and k, the post-norms and
the position bias's MLP: a few operations a token (about 10 C against the
products' 24 C^2), well under a thousandth of the block's."""

from benchmark import work
from benchmark.readers import roofline

OPS = ("_SwinV2BlockFn",)


def read(r):
    return roofline(r, OPS, lambda m, b: work.swin_work(m, b, False))
