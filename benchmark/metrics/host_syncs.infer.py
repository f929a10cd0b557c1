"""host_syncs.infer: the CUDA calls that wait for the card
(``cuda*Synchronize``, a synchronous ``cudaMemcpy``) started inside the
timeline pass's step spans, a serving step (a batch)."""

from benchmark.spans import host_syncs


def read(r):
    return host_syncs(r, "infer")
