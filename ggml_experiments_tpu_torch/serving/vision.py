"""Continuous-batching MobileViT serving engine.

The vision counterpart of :class:`~.engine.DecodeEngine`: ``features`` and
``classify`` requests arrive at any time and collate into device batches of
a fixed size ladder (default 8, 32, 128), run through the model's forward
(the fused kernels and all), and come back through a depth-bounded readback
pipeline so that the device computes the next batch while the host reads the
last.

* A worker thread owns the device; ``submit`` returns a future-like
  :class:`VisionRequest`.
* The collation loop never waits for a full batch: it ships the longest
  queued burst of one kind at the smallest ladder size that holds it, padding
  the tail (``stats.padded_images``).
* ``transport='u8'`` (default): requests carry the resized u8 canvas
  (``utils.image.preprocess_canvas_u8``) and the x/255 normalisation runs on
  the device, a quarter of the host-to-device bytes of f32 images.
* Readback: each batch's output is copied into a pinned host buffer with a
  non-blocking copy and a CUDA event recorded after it; the loop blocks on
  the oldest event only when more than ``pipeline_depth`` batches are in
  flight.
* Cancel: a queued request never dispatches; one inside a batch completes on
  the device and its result is dropped.
* A worker exception releases every waiting request with the error; ``stop``
  finishes the batches in flight and releases the requests still queued
  (they raise ``RuntimeError`` from ``result``).
* ``stats.breakdown()`` splits the wall clock into collate, dispatch,
  readback and distribute.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import resolve_dtype


@dataclasses.dataclass
class VisionRequest:
    image: np.ndarray           # (H, W, 3): u8 canvas or preprocessed float32
    kind: str = "classify"      # 'classify' | 'features'
    id: int = -1
    _done: threading.Event = dataclasses.field(default_factory=threading.Event)
    _result: Optional[np.ndarray] = None
    _canceled: bool = False
    _error: Optional[Exception] = None

    def cancel(self) -> None:
        """A queued request never dispatches; one already inside a device batch
        completes there and its result is dropped."""
        self._canceled = True
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(f"vision request {self.id} timed out")
        if self._error is not None:
            raise RuntimeError(f"vision request {self.id} did not run: "
                               f"{self._error!r}") from self._error
        if self._canceled:
            raise RuntimeError(f"vision request {self.id} was canceled")
        return self._result


@dataclasses.dataclass
class VisionStats:
    images_done: int = 0
    requests_canceled: int = 0
    batches: int = 0
    padded_images: int = 0      # ladder padding: dispatched but unclaimed rows
    wall_time_s: float = 0.0
    collate_s: float = 0.0      # queue drain + host stack/pad
    dispatch_s: float = 0.0     # host-to-device copy and the forward's launches
    readback_s: float = 0.0     # blocking wait for the oldest batch's output
    distribute_s: float = 0.0   # handing results to requests
    readback_bytes: int = 0

    @property
    def images_per_s(self) -> float:
        return self.images_done / self.wall_time_s if self.wall_time_s else 0.0

    def breakdown(self) -> dict:
        total = max(self.wall_time_s, 1e-9)
        return {
            "images_per_s": round(self.images_per_s, 1),
            "batches": self.batches,
            "pad_fraction": round(
                self.padded_images / max(self.images_done + self.padded_images, 1), 4),
            "collate_share": round(self.collate_s / total, 4),
            "dispatch_share": round(self.dispatch_s / total, 4),
            "readback_share": round(self.readback_s / total, 4),
            "distribute_share": round(self.distribute_s / total, 4),
            "readback_mb": round(self.readback_bytes / 1e6, 2),
        }


class _Inflight:
    """One dispatched batch: its requests, its padding, the host buffer its
    output is copied into, and the event recorded after the copy."""

    def __init__(self, out: torch.Tensor, reqs: List[VisionRequest], n_pad: int):
        self.reqs, self.n_pad = reqs, n_pad
        if out.device.type == "cuda":
            self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = out, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class VisionEngine:
    """Continuous-batching image inference over MobileViT parameters.

    ``batch_sizes``: ascending static ladder; a burst ships at the smallest
    size that holds it (the largest is the throughput shape).
    ``pipeline_depth``: batches in flight before the loop waits for the
    oldest readback."""

    def __init__(self, params, *, image_size: int = 256,
                 batch_sizes: Tuple[int, ...] = (8, 32, 128), compute_dtype=torch.bfloat16,
                 pipeline_depth: int = 2, max_pending: int = 4096, transport: str = "u8"):
        from ggml_experiments_tpu_torch.models.mobilevit import classify, extract_features

        self.params = params
        self.device = params.device
        self.image_size = int(image_size)
        self.batch_sizes = tuple(sorted(int(b) for b in batch_sizes))
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.max_pending = int(max_pending)
        self._compute_dtype = resolve_dtype(compute_dtype)
        if transport not in ("u8", "f32"):
            raise ValueError(f"transport must be 'u8' or 'f32', got {transport!r}")
        self.transport = transport
        self._fns = {"classify": classify, "features": extract_features}
        if params.classifier_kernel is None:
            del self._fns["classify"]
        self._queues: Dict[str, deque] = {k: deque() for k in self._fns}
        self._qlock = threading.Lock()
        self._pending = 0   # queued, not yet collated (backpressure gauge)
        self._open = 0      # submitted, not yet resolved (drain gauge)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_id = 0
        self.stats = VisionStats()
        self.error: Optional[Exception] = None

    # -- submission -----------------------------------------------------------

    def submit(self, image: np.ndarray, kind: str = "classify") -> VisionRequest:
        if self.error is not None:
            raise RuntimeError(f"vision engine failed: {self.error!r}") from self.error
        if kind not in self._fns:
            raise ValueError(f"kind must be one of {sorted(self._fns)}, got {kind!r}")
        dt = np.uint8 if self.transport == "u8" else np.float32
        img = np.asarray(image)
        if img.dtype != dt:
            raise ValueError(
                f"transport={self.transport!r} expects {np.dtype(dt).name} images, got "
                f"{img.dtype} (u8: utils.image.preprocess_canvas_u8; f32: utils.image.preprocess)")
        want = (self.image_size, self.image_size, 3)
        if img.shape != want:
            raise ValueError(f"image shape {img.shape} != {want} (preprocess with utils.image "
                             f"first)")
        with self._qlock:
            if self._pending >= self.max_pending:
                raise RuntimeError(f"vision engine backlog at max_pending={self.max_pending}")
            req = VisionRequest(image=img, kind=kind, id=self._next_id)
            self._next_id += 1
            self._queues[kind].append(req)
            self._pending += 1
            self._open += 1
        self._wake.set()
        return req

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="vision-engine")
        self._thread.start()

    def stop(self) -> None:
        """Finish the batches in flight, then release every request still
        queued: its ``result()`` raises."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=600)
            self._thread = None
        self._release_queued(RuntimeError("the vision engine stopped before the request ran"))

    def run_until_idle(self, timeout: float = 600.0) -> None:
        """Synchronous drain: start if needed, wait until nothing is open."""
        self.start()
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            with self._qlock:
                if self._open == 0:
                    return
            if self.error is not None:
                raise RuntimeError(f"vision engine failed: {self.error!r}") from self.error
            time.sleep(0.002)
        raise TimeoutError("vision engine did not drain")

    # -- worker ---------------------------------------------------------------

    def _release_queued(self, exc: Exception, extra=()) -> None:
        with self._qlock:
            leftovers = [r for q in self._queues.values() for r in q] + list(extra)
            for q in self._queues.values():
                q.clear()
            self._pending = 0
            for r in leftovers:
                if not r._done.is_set():
                    r._error = exc
                    r._done.set()
                self._open -= 1

    def _collate(self):
        """Pop the longest kind-homogeneous burst: (kind, requests) or None."""
        with self._qlock:
            kind = max(self._queues, key=lambda k: len(self._queues[k]))
            q = self._queues[kind]
            if not q:
                return None
            reqs: List[VisionRequest] = []
            while q and len(reqs) < self.batch_sizes[-1]:
                r = q.popleft()
                self._pending -= 1
                if r._canceled:
                    self.stats.requests_canceled += 1
                    self._open -= 1
                    continue
                reqs.append(r)
            return (kind, reqs) if reqs else None

    def _forward(self, kind: str, x: np.ndarray) -> torch.Tensor:
        xt = torch.from_numpy(x)
        if self.device.type == "cuda":
            xt = xt.pin_memory().to(self.device, non_blocking=True)
        if self.transport == "u8":
            xt = xt.float() / 255.0
        return self._fns[kind](self.params, xt, compute_dtype=self._compute_dtype)

    def _flush_oldest(self, inflight: deque) -> None:
        batch = inflight.popleft()
        t0 = time.perf_counter()
        out = batch.wait()
        self.stats.readback_s += time.perf_counter() - t0
        self.stats.readback_bytes += out[: len(batch.reqs)].nbytes
        t1 = time.perf_counter()
        for i, r in enumerate(batch.reqs):
            if r._canceled:
                self.stats.requests_canceled += 1
                continue
            r._result = out[i].copy()
            r._done.set()
            self.stats.images_done += 1
        with self._qlock:
            self._open -= len(batch.reqs)
        self.stats.padded_images += batch.n_pad
        self.stats.batches += 1
        self.stats.distribute_s += time.perf_counter() - t1

    def _run(self) -> None:
        inflight: deque = deque()
        reqs: List[VisionRequest] = []   # the burst in hand
        t_start = time.perf_counter()
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                burst = self._collate()
                if burst is None:
                    while inflight:
                        self._flush_oldest(inflight)
                    self.stats.wall_time_s = time.perf_counter() - t_start
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                kind, reqs = burst
                b = next((s for s in self.batch_sizes if s >= len(reqs)), self.batch_sizes[-1])
                dt = np.uint8 if self.transport == "u8" else np.float32
                x = np.zeros((b, self.image_size, self.image_size, 3), dt)
                for i, r in enumerate(reqs):
                    x[i] = r.image
                self.stats.collate_s += time.perf_counter() - t0
                t1 = time.perf_counter()
                out = self._forward(kind, x)
                inflight.append(_Inflight(out, reqs, b - len(reqs)))
                self.stats.dispatch_s += time.perf_counter() - t1
                reqs = []
                while len(inflight) > self.pipeline_depth:
                    self._flush_oldest(inflight)
            while inflight:
                self._flush_oldest(inflight)
        except Exception as exc:  # release every waiter (the decode engine's policy)
            self.error = exc
            extra = list(reqs) + [r for batch in inflight for r in batch.reqs]
            self._release_queued(exc, extra)
        finally:
            self.stats.wall_time_s = time.perf_counter() - t_start
