"""optimizer_ms.train: the device time of the kernels, copies and sets charged
to the Nadam update's (``strajnet.optimizer``) span in the attribution
pass, a training step, in ms."""

from benchmark.spans import layer_ms


def read(r):
    return layer_ms(r, "optimizer")
