"""encoder_idle_ms.train: the card's idle time a training step put down to the
encoder's span: each idle gap of the timeline pass split by overlap over
the innermost program spans open during it, in ms."""

from benchmark.spans import idle_ms


def read(r):
    return idle_ms(r, "encoder")
