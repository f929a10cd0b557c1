"""mfu.infer: the whole step's share of the card's bf16 peak (989
TFLOP/s): the FLOPs of one step of the plain reference at the cell's shapes
(FlopCounterMode; one forward) times the window's steps,
over the window."""

from benchmark.readers import mfu


def read(r):
    return mfu(r)
