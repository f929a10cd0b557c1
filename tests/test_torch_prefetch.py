"""The device prefetch (``data/pipeline.py::prefetch_to_device``) and its
producer thread (``background``).

On the CPU: the batches in order and equal, the producer's exceptions, an
early stop. On a card (marked ``cuda``, skipped without one; run there with
``CUDA_VISIBLE_DEVICES=0 python -m pytest tests/test_torch_prefetch.py -m
cuda --noconftest``): the same through pinned buffers and a side stream, with
a consumer that holds its stream back, so that a batch whose buffer were
refilled or reused too early would arrive changed. The file imports no JAX.
"""

import threading

import numpy as np
import pytest
import torch

from strajnet_tpu_torch.config import ULTRA_TINY_MODEL_CONFIG as CFG
from strajnet_tpu_torch.data.pipeline import background, prefetch_to_device
from strajnet_tpu_torch.data.synthetic import synthetic_batch


def _batches(count=3, seed=0):
    """Synthetic batches; the last one smaller (a ragged tail), the first
    with scenario ids."""
    src = [synthetic_batch(CFG, 2 if i < count - 1 else 1, seed=seed + i)
           for i in range(count)]
    src[0]["scenario/id"] = np.array([b"a", b"b"])
    return src


def _assert_same(got, src):
    assert len(got) == len(src)
    for a, b in zip(got, src):
        assert set(a) == set(b)
        for k in b:
            if k == "scenario/id":
                assert isinstance(a[k], np.ndarray)
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert isinstance(a[k], torch.Tensor)
                assert a[k].dtype == torch.from_numpy(b[k]).dtype
                np.testing.assert_array_equal(a[k].cpu().numpy(), b[k])


def test_prefetch_on_the_cpu_yields_the_batches_in_order():
    src = _batches()
    _assert_same(list(prefetch_to_device(iter(src), "cpu")), src)
    assert list(prefetch_to_device(iter([]), "cpu")) == []


def test_prefetch_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="--device cpu"):
        next(prefetch_to_device(iter([{"a": np.zeros(2)}])))


def test_producer_thread_keeps_order_and_surfaces_its_exception():
    assert list(background(iter(range(50)), lambda x: x * 2, size=2)) == \
        [2 * i for i in range(50)]
    assert list(background(iter([]), lambda x: x)) == []

    def failing():
        yield from range(3)
        raise OSError("bad record")

    got = []
    with pytest.raises(OSError, match="bad record"):
        for item in background(failing(), lambda x: x):
            got.append(item)
    assert got == [0, 1, 2]

    def fn(x):
        if x == 2:
            raise ValueError("bad batch")
        return x

    with pytest.raises(ValueError, match="bad batch"):
        list(background(iter(range(5)), fn))


def test_producer_thread_stops_when_the_consumer_does():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield i
            i += 1

    before = threading.active_count()
    items = background(endless(), lambda x: x, size=2)
    assert [next(items) for _ in range(3)] == [0, 1, 2]
    items.close()
    assert threading.active_count() == before
    assert len(pulled) <= 3 + 2 + 2       # consumed, queued, in flight


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the prefetch's copies are CUDA "
                    "copies")
    return torch.device("cuda")


@pytest.mark.cuda
def test_prefetch_to_the_card_keeps_every_batch_intact(card):
    """Twenty batches through a ring of two pinned slots; the consumer's
    stream sleeps before it reads each batch and then overwrites it, so the
    producer runs ahead as far as the queue lets it."""
    src = _batches(20, seed=3)
    got = []
    for batch in prefetch_to_device(iter(src), card, size=2):
        torch.cuda._sleep(2_000_000)
        copy = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in batch.items()}
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                v.zero_()
        got.append(copy)
    torch.cuda.synchronize()
    assert all(v.device.type == "cuda" for b in got for v in b.values()
               if isinstance(v, torch.Tensor))
    _assert_same(got, src)


@pytest.mark.cuda
def test_prefetch_to_the_card_surfaces_the_readers_exception(card):
    def reader():
        yield from _batches(2)
        raise OSError("bad record")

    seen = 0
    with pytest.raises(OSError, match="bad record"):
        for _ in prefetch_to_device(reader(), card):
            seen += 1
    assert seen == 2
    before = threading.active_count()
    items = prefetch_to_device(iter(_batches(10)), card)
    next(items)
    items.close()
    assert threading.active_count() == before
