"""Background sample pipeline: the reference's DataLoader worker pool
(train.py:118-122, 8 worker processes decoding and resizing on the CPU).

The port's own copy of wildmvs/data/prefetch.py. A thread pool loads
samples ahead of the device step (the native decoder, cpp/image.cpp, and
PIL both release the GIL while they decode and resize) and delivers them
in order, as DataLoader does: every reference view of an occlusion-masked
step sees the same batch.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor


def iterate(dataset, indices, num_workers: int = 4, prefetch_depth: int = 8):
    """Yield dataset[i] for i in indices, computed by a background thread
    pool with up to `prefetch_depth` samples in flight, delivered in order.

    num_workers <= 0 is plain synchronous iteration (--num_workers 0, as
    torch DataLoader's).
    """
    if num_workers <= 0:
        for i in indices:
            yield dataset[int(i)]
        return
    prefetch_depth = max(prefetch_depth, num_workers)
    it = iter(indices)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = deque()
        try:
            for _ in range(prefetch_depth):
                i = next(it, None)
                if i is None:
                    break
                futures.append(pool.submit(dataset.__getitem__, int(i)))
            while futures:
                sample = futures.popleft().result()
                i = next(it, None)
                if i is not None:
                    futures.append(pool.submit(dataset.__getitem__, int(i)))
                yield sample
        finally:
            for f in futures:
                f.cancel()


def iterate_batches(dataset, order, batch_size: int, collate,
                    num_workers: int = 4, prefetch_depth: int = 8):
    """Batched variant: yields collate([...]) of consecutive index groups,
    INCLUDING a final partial batch — the reference's DataLoader defaults to
    drop_last=False (train.py:120-122), so tail samples are never
    skipped."""
    samples = iterate(dataset, order, num_workers=num_workers,
                      prefetch_depth=max(prefetch_depth, batch_size))
    buf = []
    for s in samples:
        buf.append(s)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
    if buf:
        yield collate(buf)
