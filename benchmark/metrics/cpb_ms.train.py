"""cpb_ms.train: the device time of the kernels, copies and sets charged to
the SwinV2 blocks' position bias (the program's ``strajnet.swinv2_cpb`` span
around each block's bias MLP, sigmoid and gather) in the attribution pass,
forward and backward: a kernel launched by a backward node goes to the span
of the node's forward operation; per training step, in ms.

The span lies inside ``strajnet.encoder``; the innermost span takes the
time, so the encoder's readings leave this time out, its device time and
its idle time alike."""

from benchmark.spans import device_ns

SPAN = "strajnet.swinv2_cpb"


def read(r):
    got = device_ns(r.trace)
    if got is None:
        return None
    return got.get(SPAN, 0) / r.trace.steps / 1e6
