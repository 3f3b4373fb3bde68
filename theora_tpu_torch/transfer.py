"""Host <-> device copies that do not synchronise the stream.

A copy from pageable host memory to the card, or from the card into
pageable host memory, makes PyTorch wait for the whole stream; once a
later chunk's work is queued, that wait holds the host until the device
has run all of it. These helpers copy through pinned host buffers with
non_blocking=True instead, so a stage can queue its work and its copies
and return. Each caller keeps the pinned buffers it was given until the
copies are done (PyTorch's pinned-memory pool also holds a buffer back
until the copy that reads it has run). On the CPU they copy nothing.
"""
from __future__ import annotations

import numpy as np
import torch

# Byte counts of the device->host copies started by Download, appended
# in order when this is set to a list (chip_smoke.py reads it). A list
# append is atomic, so under several threads (parallel/transcode.py) the
# log holds every thread's copies, interleaved.
copy_log: list[int] | None = None


def upload(arr: np.ndarray, device: torch.device,
           keep: list | None = None) -> torch.Tensor:
    """arr on `device`. On the card the copy starts from a pinned copy of
    arr without waiting; the pinned buffer is appended to keep. On the
    CPU: torch.from_numpy(arr)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    pinned = t.pin_memory()
    if keep is not None:
        keep.append(pinned)
    return pinned.to(device, non_blocking=True)


class Download:
    """Device->host copies of a list of tensors, started at construction
    into pinned buffers, with an event recorded after them; wait() blocks
    on that event only and returns numpy arrays. On the CPU the tensors
    are the result."""

    def __init__(self, tensors: list):
        self._src = tensors
        self.event = None
        if not tensors or tensors[0].device.type != "cuda":
            self._host = tensors
            return
        self._host = []
        for t in tensors:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            self._host.append(buf)
            if copy_log is not None:
                copy_log.append(t.numel() * t.element_size())
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> list[np.ndarray]:
        """The host copies; the first call waits for the event."""
        if self._src is not None:
            if self.event is not None:
                self.event.synchronize()
            self._src = None
        return [t.numpy() for t in self._host]
