"""swinv2_bwd_roofline.train: the encoder's SwinV2 blocks, backward: the least
time of their work (twice the forward's products,
benchmark/work.py::swin_work) over the device time of the kernels launched
inside the program's ``_SwinV2BlockFnBackward`` nodes, per step. As the
forward's reader, the work leaves out the normalisation's, the post-norms'
and the position bias's few operations a token."""

from benchmark import work
from benchmark.readers import roofline

OPS = ("_SwinV2BlockFnBackward",)


def read(r):
    return roofline(r, OPS, lambda m, b: work.swin_work(m, b, True))
