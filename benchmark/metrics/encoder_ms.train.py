"""encoder_ms.train: the device time of the kernels, copies and sets charged
to the Swin encoder's (``strajnet.encoder``) span in the attribution pass,
forward and backward: a kernel launched by a backward node goes to the span
of the node's forward operation; per training step, in ms."""

from benchmark.spans import layer_ms


def read(r):
    return layer_ms(r, "encoder")
