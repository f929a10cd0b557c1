"""idle_share.train: the share of the measured window in which nothing ran
on the card: one minus the device's busy time a step (the union of the
kernels', copies' and sets' intervals in the traced steps, over their
number) times the window's steps, over the window."""

from benchmark.readers import idle_share


def read(r):
    return idle_share(r)
