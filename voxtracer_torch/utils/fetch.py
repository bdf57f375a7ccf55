"""One frame of lookahead between the device and the host.

The viewers show frame N while the card renders frame N + 1: a blocking
fetch of each frame right after its ``render()`` would leave the card
idle while the host waits, formats and encodes.  The JAX package starts
the copy with ``copy_to_host_async`` and reads it a frame later
(``voxtracer/app/viewer.py``, ``voxtracer/app/web.py``); PyTorch has no
such call, so :class:`LookaheadFetch` does it by hand:

* two pinned host buffer sets (image and ray counters), used in turn: a
  copy into pageable memory with ``non_blocking=True`` is synchronous;
* the frame's u8 image made contiguous on the compute stream (the
  encode writes it so already: no copy), then an event recorded there
  behind the frame's last kernel;
* ``copy_(..., non_blocking=True)`` of the image and of the ray
  counters on a copy stream of the fetch's own, made once for the
  image's device, which first waits for that event, and a CUDA event
  recorded behind the copies on the same stream.  The copy runs on the
  PCIe link and needs no SM: off the compute stream it overlaps the next
  frame's kernels instead of holding them back;
* ``record_stream`` on the copied tensors, so that the caching allocator
  hands their memory (the direct path's arena of the frame) to the
  compute stream again only once the copy stream has read it, also
  where a frame in flight is forgotten (:meth:`drop`, a resize);
* the previous frame's event is waited for before the host reads its
  buffers, which it may then do until the next :meth:`push`: a buffer
  read before its copy completed would hold a torn frame.

Nothing else in a loop around it may wait for the card (``.cpu()``,
``.item()``, a print of a device tensor): any of these serialises the
pipeline.  On the CPU the frame's tensors are the host's already and
come back as they are, still one frame behind.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .timing import COUNTS, span


class LookaheadFetch:
    """``push(out)`` starts the host copy of a frame's ``image`` and
    ``rays`` and returns the previous frame's ``(image (H, W, 3) u8,
    rays)``, or None for the first frame after construction or
    :meth:`drop`."""

    def __init__(self):
        self._slots: list = [None, None]  # (image, rays, event) in turn
        self._turn = 0
        self._pending: Optional[Tuple] = None
        self._stream: Optional[torch.cuda.Stream] = None  # the copies'
        self._ready: Optional[torch.cuda.Event] = None  # behind a frame

    def push(self, out: Dict[str, torch.Tensor]
             ) -> Optional[Tuple[np.ndarray, int]]:
        image, rays = out["image"], out["rays"]
        if image.device.type == "cuda":
            with span("vt.fetch.copy"):
                current = self._copy(image, rays)
        else:
            current = (image, rays, None)
        previous, self._pending = self._pending, current
        return None if previous is None else self._read(previous)

    def flush(self) -> Optional[Tuple[np.ndarray, int]]:
        """The frame in flight, waiting for its copy; None if there is
        none."""
        pending, self._pending = self._pending, None
        return None if pending is None else self._read(pending)

    def drop(self):
        """Forget the frame in flight (its size is gone after a resize)."""
        self._pending = None

    def _copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        """The copy stream on ``device``, made at its first frame; the
        slots' events belong to the stream's device, so a new device
        gets new slots too."""
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
            self._ready = torch.cuda.Event()
            self._slots = [None, None]
        return self._stream

    def _copy(self, image: torch.Tensor, rays: torch.Tensor):
        COUNTS["fetch.copies"] += 1
        stream = self._copy_stream(image.device)
        image = image.contiguous()
        compute = torch.cuda.current_stream(image.device)
        self._ready.record(compute)
        stream.wait_event(self._ready)
        slot = self._slots[self._turn]
        if slot is None or slot[0].shape != image.shape:
            slot = (torch.empty(image.shape, dtype=image.dtype,
                                pin_memory=True),
                    torch.empty(rays.shape, dtype=rays.dtype,
                                pin_memory=True),
                    torch.cuda.Event())
            self._slots[self._turn] = slot
        host_image, host_rays, event = slot
        # set_stream, not the ``torch.cuda.stream`` context: a viewer
        # frame's host time counts, and the context costs about 15 us
        # more a call (18 against 3 on an H100's host, torch 2.11)
        torch.cuda.set_stream(stream)
        try:
            host_image.copy_(image, non_blocking=True)
            host_rays.copy_(rays, non_blocking=True)
            event.record(stream)
            if (torch._C._cuda_getCurrentRawStream(image.device.index)
                    == stream.cuda_stream):
                COUNTS["fetch.stream_copies"] += 1
        finally:
            torch.cuda.set_stream(compute)
        image.record_stream(stream)
        rays.record_stream(stream)
        self._turn ^= 1
        return slot

    @staticmethod
    def _read(slot) -> Tuple[np.ndarray, int]:
        image, rays, event = slot
        if event is not None:
            with span("vt.fetch.wait"):
                event.synchronize()
            COUNTS["host.waits"] += 1
        return image.numpy(), int(rays.sum())
