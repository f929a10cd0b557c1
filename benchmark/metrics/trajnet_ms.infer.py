"""trajnet_ms.infer: the device time of the kernels, copies and sets charged
to TrajNet's, the query's build with it (``strajnet.trajnet``) span in the
attribution pass, a serving step (a batch), in ms."""

from benchmark.spans import layer_ms


def read(r):
    return layer_ms(r, "trajnet")
