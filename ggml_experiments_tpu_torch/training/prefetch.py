"""Background host-to-device input prefetching for training.

A daemon thread pulls host batches, copies them to the device and keeps a
small queue full, so the device does not wait on the host. Double-buffered
by default (depth 2). On a GPU each array goes through a pinned host buffer
and a non-blocking copy; the copy is queued on the device's current stream,
ahead of the step that consumes it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device

_SENTINEL = object()


def _to_device(item, dev: torch.device, split):
    if isinstance(item, (tuple, list)):
        return type(item)(_to_device(x, dev, split) for x in item)
    if isinstance(item, dict):
        return {k: _to_device(v, dev, split) for k, v in item.items()}
    a = np.asarray(item)
    if split is not None and a.ndim:
        i, n = split
        if a.shape[0] % n:
            raise ValueError(f"a batch of {a.shape[0]} rows does not divide over {n} ranks")
        per = a.shape[0] // n
        a = a[i * per:(i + 1) * per]
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def prefetch_to_device(batches: Iterable, *, depth: int = 2, device: DeviceLike = None,
                       split: Optional[Tuple[int, int]] = None) -> Iterator:
    """Wrap a host batch iterable, yielding the same trees (tuples, lists and
    dicts of numpy arrays or scalars) as tensors on ``device`` (default
    ``cuda``), in order. ``split=(i, n)`` moves only the i-th of n equal
    slices of every array's leading dim (a rank's rows of the global batch
    along the mesh's ``data`` axis, as the JAX package's ``sharding=P('data')``
    places them). An exception in the producer is raised in the consumer
    once the batches before it have been delivered. Closing the generator
    early stops the producer."""
    dev = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in batches:
                if not put(_to_device(item, dev, split)):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
