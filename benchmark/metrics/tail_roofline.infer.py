"""tail_roofline.infer: the decoder's two tails (upsample, 3x3 conv, elu,
3x3 conv to two channels): the least time of their work in the phase form
(benchmark/work.py::tails_work) over the device time of the kernels
launched inside the program's ``_DecoderTailFn`` forwards, per step."""

from benchmark import work
from benchmark.readers import roofline

OPS = ("_DecoderTailFn",)


def read(r):
    return roofline(r, OPS, work.tails_work)
