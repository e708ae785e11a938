"""Input pipeline — host→device loading with prefetch, the port of
``tpu_p2p/utils/data.py``'s :class:`DeviceLoader`.

On the card each host batch is copied into pinned (page-locked) host
memory and sent with ``non_blocking=True``, so the copy is queued on
the current stream and runs while the host goes on; the loader keeps
``prefetch`` batches in flight, so the copy for step ``i+k`` is queued
before step ``i``'s work. PyTorch's pinned-memory allocator holds a
pinned buffer until the copy that reads it has finished. On the CPU the
batch is handed over as is.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

Batch = Tuple[Any, ...]  # tensors or numpy arrays


def _to_device(a, device: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeviceLoader:
    """Iterate device-resident batches with ``prefetch`` in flight.

    ``source`` yields host batches: tuples of tensors or numpy arrays.
    """

    def __init__(self, source: Iterable[Batch], device,
                 prefetch: int = 2) -> None:
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self._it = iter(source)
        self._device = torch.device(device)
        self._prefetch = prefetch
        self._queue: deque = deque()
        self._exhausted = False
        self._error: Optional[Exception] = None

    def _put(self, host_batch: Batch) -> Batch:
        return tuple(_to_device(a, self._device) for a in host_batch)

    def _fill(self) -> None:
        while (not self._exhausted and self._error is None
               and len(self._queue) < self._prefetch):
            try:
                self._queue.append(self._put(next(self._it)))
            except StopIteration:
                self._exhausted = True
            except Exception as e:  # noqa: BLE001 — deferred below.
                # A source error during top-up must not swallow batches
                # already in flight: park it and raise it once the
                # queue has drained.
                self._error = e

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        self._fill()
        if self._queue:
            batch = self._queue.popleft()
            self._fill()  # keep the pipe full before handing control back
            return batch
        if self._error is not None:
            e, self._error = self._error, None
            raise e
        raise StopIteration

    @property
    def in_flight(self) -> int:
        """Batches currently queued on the device."""
        return len(self._queue)
