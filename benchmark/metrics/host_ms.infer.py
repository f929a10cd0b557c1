"""host_ms.infer: the host's dispatch time a serving step (a batch): the step
span's duration in the timeline pass less the union of its waiting CUDA
calls (synchronises, synchronous copies, launches over 100 us), over the
traced steps, in ms."""

from benchmark.spans import host_ms


def read(r):
    return host_ms(r, "infer")
