"""launches.train: the kernel launches (``cudaLaunch*``, ``cuLaunch*``)
started inside the timeline pass's step spans, a training step."""

from benchmark.spans import launches


def read(r):
    return launches(r, "train")
