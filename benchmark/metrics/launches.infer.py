"""launches.infer: the kernel launches (``cudaLaunch*``, ``cuLaunch*``)
started inside the timeline pass's step spans, a serving step (a batch)."""

from benchmark.spans import launches


def read(r):
    return launches(r, "infer")
