"""Background-thread prefetching host->device pipeline (``dsrg_tpu/data/loader.py``).

The reference's data layers are synchronous (a dormant producer-queue exists
in ``AnnotationLayerCOCO.start_batch`` but is never started,
``pylayers.py:412,467-475``); here host IO/augmentation AND the
host->device copy overlap device compute: a worker thread fills a bounded
queue with batches that are already on the device.

On the card the worker copies from pinned memory with ``non_blocking=True``
on a CUDA stream of its own and records an event after the copies;
``__next__`` makes the consumer's current stream wait on that event and
marks every tensor as used by that stream (``record_stream``).  Without the
side stream a copy issued from the worker would queue behind the step on the
default stream; without ``record_stream`` the caching allocator could hand
the copy's memory to the side stream again while the step still reads it.
The data-parallel padding of the JAX loader (``mesh``, ``pad_rows``,
``n_valid``) waits for the port's scale-out (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from dsrg_tpu_torch._device import resolve_device


class PrefetchLoader:
    def __init__(self, dataset: Iterable[dict], device=None, prefetch: int = 2,
                 half_images: bool = True, device_in_worker: bool = True):
        """``device``: where batches go, the card by default (``"cpu"`` for
        the plain path; raises where CUDA is asked for and absent).

        ``half_images``: transfer float 'images' arrays as float16 — halves
        host->device bytes (the train step casts back to f32; the ~0.1
        absolute quantization on mean-subtracted pixels is far below the
        model's bf16 compute noise).  uint8 canvases ship as-is.

        ``device_in_worker``: issue the copy from the worker thread (default)
        so the transfer overlaps the in-flight step; False copies in
        ``__next__``.
        """
        self.dataset = dataset
        self.device = resolve_device(device)
        self.half_images = half_images
        self.device_in_worker = device_in_worker
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _to_device(self, batch: dict):
        """(batch of tensors on the device, CUDA event after its copies or None)."""
        batch = dict(batch)
        if (self.half_images and "images" in batch
                and np.issubdtype(np.asarray(batch["images"]).dtype, np.floating)):
            batch["images"] = np.asarray(batch["images"], np.float16)
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self) -> None:
        # Any exception here (dataset iteration: decode/memmap/disk IO, or
        # the copy) must reach the main loop — a silently dead producer
        # would leave __next__ blocked on the queue forever.
        try:
            for batch in self.dataset:
                if self._stop.is_set():
                    return
                self.queue.put(self._to_device(batch) if self.device_in_worker else batch)
            self.queue.put(None)
        except Exception as e:
            self.queue.put(e)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        item = self.queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        batch, event = item if self.device_in_worker else self._to_device(item)
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
