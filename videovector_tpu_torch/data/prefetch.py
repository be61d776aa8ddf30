"""Host-to-device prefetch pipeline; counterpart of
videovector_tpu/data/prefetch.py.

The reference overlaps batch preparation with compute through one boost
thread and a join-before-copy handshake (depth-1 lookahead,
ref:src/caffe/layers/base_data_layer.cpp:52-95,
ref:src/caffe/internal_thread.cpp:14-37). Here a background thread runs the
(stateful, host-side) batch source and hands batches over through a bounded
queue, `depth` deep. On a card it also makes the copy: each host batch goes
into pinned staging buffers, and from there to the card with
`non_blocking=True` on a side stream, so that the copy of batch i+1
overlaps the step on batch i. The consumer's stream waits on the copy's
event before it reads the batch, and `record_stream` keeps the caching
allocator from handing the batch's memory to the next copy while the
consumer's work still reads it. A staging buffer is written again only
after the copy out of it has completed.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from videovector_tpu_torch.device import DEFAULT, resolve


class _Staging:
    """One set of pinned host buffers (one per batch key) and the event of
    the last copy out of them."""

    def __init__(self):
        self.buffers: dict[str, torch.Tensor] = {}
        self.copied: torch.cuda.Event | None = None

    def pinned(self, key: str, arr: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(arr)
        buf = self.buffers.get(key)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self.buffers[key] = buf
        buf.copy_(src)
        return buf


class DevicePrefetcher:
    """Wrap a host batch iterator; yields batches of tensors on `device`
    (the card unless "cpu" is asked for) while the next host batch is being
    built and its copy is in flight."""

    _SENTINEL = object()

    def __init__(self, source: Iterator[dict], *, depth: int = 2,
                 device=DEFAULT,
                 transform: Callable[[dict], dict] | None = None):
        """source: iterator of dict[str, np.ndarray]. transform: applied to
        each host batch in the worker thread, before the copy."""
        self.device = resolve(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the worker thread selects the card by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._source = source
        self._transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            # a batch is queued (depth), one is consumed, one is staged
            self._staging = [_Staging() for _ in range(depth + 2)]
            self._staged = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="vvtpu-torch-prefetch")
        self._thread.start()

    def _to_device(self, batch: dict):
        """(batch of device tensors, the copy's event or None)."""
        if not self._cuda:
            return {k: torch.as_tensor(v) for k, v in batch.items()}, None
        slot = self._staging[self._staged % len(self._staging)]
        self._staged += 1
        if slot.copied is not None:
            slot.copied.synchronize()  # the last copy out of it is done
        host = {k: slot.pinned(k, np.ascontiguousarray(v))
                for k, v in batch.items()}
        with torch.cuda.stream(self._stream):
            out = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            slot.copied = torch.cuda.Event()
            slot.copied.record(self._stream)
        return out, slot.copied

    def _put(self, item) -> bool:
        # bounded put, so that close() ends the thread even when the
        # consumer never drains (a worker parked in q.put holds device
        # batches and open store readers)
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            for batch in self._source:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    batch = self._transform(batch)
                if not self._put(self._to_device(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 - surfaced on next __next__
            self._exc = e
        self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        if self._stop.is_set():
            # closed or exhausted: the worker may never put again, and
            # blocking on the empty queue would hang the caller
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            self._stop.set()
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        batch, copied = item
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self):
        """Stop the worker and drop its queued batches. Safe to call any
        number of times; after close(), iteration raises StopIteration
        instead of blocking."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=5.0)
        # a worker already past its stop check may have put one last batch
        # after the drain above
        self._drain()

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
