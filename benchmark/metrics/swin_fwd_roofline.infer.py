"""swin_fwd_roofline.infer: the encoder's eight Swin blocks, forward: the
least time of their work (benchmark/work.py::swin_work) over the device
time of the kernels launched inside the program's ``_SwinBlockFn``
forwards, per step."""

from benchmark import work
from benchmark.readers import roofline

OPS = ("_SwinBlockFn",)


def read(r):
    return roofline(r, OPS, lambda m, b: work.swin_work(m, b, False))
