"""Streaming host-side data pipeline for datasets too large for device
memory (counterpart of ``divshot_tpu/gsio/loader.py``).

The device-resident ``Dataset`` keeps every image on the device; this
module is the host-resident variant:

- ``HostImageStore``: uint8 images in host memory, materialised or decoded
  on demand from paths with an LRU of decoded frames; for a card, in
  pinned (page-locked) memory, so a copy to the card runs asynchronously;
- ``Prefetcher``: a background thread that sends each scheduled view to
  the device ahead of the step that trains on it. On a card the copy is
  ``non_blocking`` on a side stream, and ``get`` makes the caller's
  stream wait on the copy's event and marks the tensor as used there
  (``record_stream``), so the caching allocator does not hand its memory
  out while the copy or the step still reads it. On the CPU it hands
  over the host tensors and does nothing more;
- ``StreamingLoop``: random views drawn ``depth`` ahead of the loop.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch


@dataclass
class HostImageStore:
    """Uint8 images on the host: materialised (V, H, W, 3), or decoded on
    demand from ``paths`` with an LRU of ``cache_size`` frames. With
    ``pin``, each frame handed out lies in pinned memory."""
    images: np.ndarray | None = None        # (V, H, W, 3) u8
    paths: list[str] | None = None
    decode: Callable[[str], np.ndarray] | None = None
    cache_size: int = 64
    pin: bool = False
    _cache: OrderedDict = field(default_factory=OrderedDict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _host: torch.Tensor | None = None

    def __post_init__(self):
        if self.images is not None:
            host = torch.from_numpy(np.ascontiguousarray(self.images))
            self._host = host.pin_memory() if self.pin else host

    @property
    def num_views(self) -> int:
        return len(self.paths) if self.paths is not None \
            else self.images.shape[0]

    def get(self, i: int) -> torch.Tensor:
        """View ``i`` as a host uint8 tensor."""
        if self._host is not None:
            return self._host[i]
        with self._lock:
            if i in self._cache:
                self._cache.move_to_end(i)
                return self._cache[i]
        img = self.decode(self.paths[i])
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        t = torch.from_numpy(np.ascontiguousarray(img))
        if self.pin:
            t = t.pin_memory()
        with self._lock:
            self._cache[i] = t
            if len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        return t


class Prefetcher:
    """Background thread that keeps up to ``depth`` upcoming views on the
    device. ``schedule(view)`` enqueues; ``get()`` returns (view, image,
    mask or None) in schedule order. A CPU ``device`` gets the host
    tensors as they are; for a card the store should ``pin``, else the
    copies wait on the host."""

    def __init__(self, store: HostImageStore, depth: int = 2,
                 masks: np.ndarray | None = None, device="cpu"):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.store = store
        self.masks = None if masks is None else HostImageStore(
            images=masks, pin=self.cuda)
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._in: "queue.Queue[int | None]" = queue.Queue()
        self._out: "queue.Queue[tuple]" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _send(self, host: torch.Tensor) -> torch.Tensor:
        return host.to(self.device, non_blocking=True) if self.cuda \
            else host

    def _run(self) -> None:
        while True:
            view = self._in.get()
            if view is None:
                return
            img = self.store.get(view)
            mask = None if self.masks is None else self.masks.get(view)
            event = None
            if self.cuda:
                with torch.cuda.stream(self._stream):
                    img, mask = self._send(img), (
                        None if mask is None else self._send(mask))
                    event = torch.cuda.Event()
                    event.record(self._stream)
            self._out.put((view, img, mask, event))

    def schedule(self, view: int) -> None:
        self._in.put(view)

    def get(self) -> tuple:
        view, img, mask, event = self._out.get()
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in (img, mask):
                if t is not None:
                    t.record_stream(stream)
        return view, img, mask

    def close(self) -> None:
        self._in.put(None)


class StreamingLoop:
    """Drives a streamed training loop: the caller's step takes (state,
    view, gt_u8 [, mask]) with the ground truth passed per step."""

    def __init__(self, store: HostImageStore, rng: np.random.Generator,
                 masks: np.ndarray | None = None, depth: int = 2,
                 device="cpu"):
        self.store = store
        self.rng = rng
        self.prefetch = Prefetcher(store, depth=depth, masks=masks,
                                   device=device)
        self.depth = depth

    def views(self, n_steps: int):
        """Yield (view, image, mask) for ``n_steps`` random views, keeping
        ``depth`` transfers in flight."""
        order = [int(self.rng.integers(self.store.num_views))
                 for _ in range(n_steps)]
        k = min(self.depth, n_steps)
        for v in order[:k]:
            self.prefetch.schedule(v)
        for i in range(n_steps):
            if i + k < n_steps:
                self.prefetch.schedule(order[i + k])
            yield self.prefetch.get()

    def close(self) -> None:
        self.prefetch.close()
