"""swin_bwd_roofline.train: the encoder's eight Swin blocks, backward: the
least time of their work (twice the forward's products,
benchmark/work.py::swin_work) over the device time of the kernels launched
inside the program's ``_SwinBlockFnBackward`` nodes, per step."""

from benchmark import work
from benchmark.readers import roofline

OPS = ("_SwinBlockFnBackward",)


def read(r):
    return roofline(r, OPS, lambda m, b: work.swin_work(m, b, True))
