"""Host-side input pipeline: TFRecords -> numpy batches -> the device.

Counterpart of ``strajnet_tpu/data/pipeline.py`` (the tf.data wiring of
reference train.py:378-389 and inference.py:254-259): per-host file sharding,
a real shuffle buffer, parallel map and prefetch, batches delivered as numpy
dicts; :func:`prefetch_to_device` (the counterpart of ``prefetch_to_mesh``)
copies them to the card ahead of the consumer.

TensorFlow loads at the first dataset built, not at import.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import numpy as np
import torch

from strajnet_tpu_torch.data.schema import (_tf, parse_test_example,
                                            parse_train_example)
from strajnet_tpu_torch.device import resolve_device


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


def _as_tensor(value) -> Union[torch.Tensor, np.ndarray]:
    """A numeric array as a tensor sharing its memory; strings (scenario
    ids) stay numpy."""
    arr = np.asarray(value)
    return arr if arr.dtype.kind in "OSU" else torch.from_numpy(arr)


class _PinnedRing:
    """Pinned host buffers for one batch key and shape, used in turn. A slot
    is refilled only after the copy that last read it has finished: its
    event is waited on first, else the card would read a half-rewritten
    buffer and the batch would be corrupt without any error. Two slots let
    one batch be staged while the previous one is copied; freed rings go
    back to PyTorch's cache of pinned memory, so a later prefetch of the
    same shapes allocates nothing."""

    def __init__(self, like: torch.Tensor, slots: int = 2):
        self.buffers = [torch.empty(like.shape, dtype=like.dtype,
                                    pin_memory=True) for _ in range(slots)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        self.next = 0

    def stage(self, src: np.ndarray, device: torch.device,
              stream: torch.cuda.Stream, event: torch.cuda.Event
              ) -> torch.Tensor:
        i = self.next
        self.next = (i + 1) % len(self.buffers)
        if self.events[i] is not None:
            self.events[i].synchronize()
        buf = self.buffers[i]
        # numpy copies on this thread alone, without the interpreter lock;
        # a torch copy would take every core from the consumer's thread,
        # whose launches pace the step
        np.copyto(buf.numpy(), src, casting="no")
        with torch.cuda.stream(stream):
            out = buf.to(device, non_blocking=True)
        self.events[i] = event
        return out


def background(iterator: Iterable, fn: Callable, size: int = 2) -> Iterator:
    """Yields ``fn(item)`` for each item of ``iterator``, in order, with
    ``fn`` run on a producer thread up to ``size`` items ahead. An exception
    of the producer (of ``iterator`` or of ``fn``) is raised here, after the
    items before it. When the consumer stops early, the producer stops after
    the item at hand and is joined."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()
    err: List[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in iterator:
                if not put(fn(item)):
                    return
        except Exception as e:  # raised on the consumer's side
            err.append(e)
        finally:
            put(end)

    thread = threading.Thread(target=producer, name="prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        thread.join()


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]],
                       device: Union[str, torch.device] = "cuda",
                       size: int = 2) -> Iterator[Dict[str, object]]:
    """Yields the batches of ``iterator`` (dicts of numpy arrays) as tensors
    on ``device``, in order; string arrays (scenario ids) stay numpy.

    On a CUDA device a producer thread (:func:`background`) copies each
    batch into pinned host buffers (a ring per key and shape, allocated
    once) and from there to the card with ``non_blocking=True`` on a side
    stream, ``size`` batches ahead of the consumer, so that the copy of
    batch N+1 runs under the compute of batch N. The consumer's stream waits
    on each batch's copy event, and each tensor handed out is recorded on
    that stream, so the caching allocator does not reuse its memory before
    the consumer's work on it ends. An exception of the producer (the
    reader's) is raised here. On the CPU the batches are ``torch.from_numpy``
    views, in order; a CUDA device that is not there raises.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: _as_tensor(v) for k, v in batch.items()}
        return

    stream = torch.cuda.Stream(device=device)
    rings: Dict[Tuple[str, tuple, str], _PinnedRing] = {}

    def place(batch):
        event = torch.cuda.Event()
        out = {}
        with torch.cuda.device(device):
            for k, v in batch.items():
                arr = np.asarray(v)
                if arr.dtype.kind in "OSU":
                    out[k] = arr
                    continue
                key = (k, arr.shape, arr.dtype.str)
                if key not in rings:
                    rings[key] = _PinnedRing(torch.from_numpy(arr))
                out[k] = rings[key].stage(arr, device, stream, event)
            event.record(stream)
        return out, event

    with contextlib.closing(background(iterator, place, size)) as items:
        for batch, event in items:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
            yield batch
