"""Host-side input pipeline: TFRecords -> numpy batches.

Counterpart of ``strajnet_tpu/data/pipeline.py`` (the tf.data wiring of
reference train.py:378-389 and inference.py:254-259): per-host file sharding,
a real shuffle buffer, parallel map and prefetch, batches delivered as numpy
dicts, which the caller copies to its device. The device prefetch comes with
the training loop (ROADMAP.md).

TensorFlow loads at the first dataset built, not at import.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from strajnet_tpu_torch.data.schema import (_tf, parse_test_example,
                                            parse_train_example)


def make_train_dataset(file_pattern: str, batch_size: int,
                       shuffle_buffer: int = 2048,
                       shard_index: int = 0, shard_count: int = 1,
                       seed: Optional[int] = None,
                       repeat: bool = False, compact: bool = False):
    tf = _tf()
    files = tf.io.matching_files(file_pattern)
    ds = tf.data.TFRecordDataset(files, compression_type="",
                                 num_parallel_reads=tf.data.AUTOTUNE)
    if shard_count > 1:
        ds = ds.shard(shard_count, shard_index)
    if repeat:
        ds = ds.repeat()
    ds = ds.shuffle(shuffle_buffer, seed=seed, reshuffle_each_iteration=True)
    ds = ds.map(lambda ex: parse_train_example(ex, compact=compact),
                num_parallel_calls=tf.data.AUTOTUNE)
    ds = ds.batch(batch_size, drop_remainder=True)
    ds = ds.prefetch(tf.data.AUTOTUNE)
    return ds


def make_eval_dataset(file_pattern: str, batch_size: int,
                      shard_index: int = 0, shard_count: int = 1,
                      compact: bool = False, drop_remainder: bool = True):
    """``drop_remainder``: a validation pass inside training keeps it True so
    that every batch has one shape; the evaluate CLI passes False so that
    the last, partial batch of the split is evaluated too."""
    tf = _tf()
    files = tf.io.matching_files(file_pattern)
    ds = tf.data.TFRecordDataset(files, compression_type="",
                                 num_parallel_reads=tf.data.AUTOTUNE)
    if shard_count > 1:
        ds = ds.shard(shard_count, shard_index)
    ds = ds.map(lambda ex: parse_train_example(ex, compact=compact),
                num_parallel_calls=tf.data.AUTOTUNE)
    ds = ds.batch(batch_size, drop_remainder=drop_remainder)
    ds = ds.prefetch(tf.data.AUTOTUNE)
    return ds


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
