"""Host-side input pipeline: TFRecords -> numpy batches.

Counterpart of the test-split part of ``strajnet_tpu/data/pipeline.py`` (the
tf.data wiring of reference inference.py:254-259): parallel map and prefetch,
batches delivered as numpy dicts, which the caller copies to its device. The
train and eval datasets come with the training loop (ROADMAP.md).

TensorFlow loads at the first dataset built, not at import.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from strajnet_tpu_torch.data.schema import _tf, parse_test_example


def make_test_dataset(shard_path: str, batch_size: int = 1,
                      compact: bool = False):
    """One shard of the test split incl. scenario ids (inference.py:254-259)."""
    tf = _tf()
    ds = tf.data.TFRecordDataset(shard_path)
    ds = ds.map(lambda ex: parse_test_example(ex, compact=compact),
                num_parallel_calls=tf.data.AUTOTUNE)
    ds = ds.batch(batch_size)
    ds = ds.prefetch(tf.data.AUTOTUNE)
    return ds


def as_numpy(dataset) -> Iterator[dict]:
    for batch in dataset:
        yield {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
               for k, v in batch.items()}
