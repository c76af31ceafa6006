"""Double-buffered host -> device batch prefetch (the port of the JAX
package's data/prefetch.py).

The reference overlaps disk IO with GPU compute through DataLoader worker
processes, but copies each batch to the device inline on the training
thread. `DevicePrefetcher` issues batch i+1's copy while step i computes:
a producer thread pulls host batches from the loader, places them on the
device and keeps up to `depth` placed batches queued ahead of the
consumer.

On a CUDA device the default placement (`CudaPlacer`) pins each array,
copies it on a side stream and records an event; the consumer's stream
waits on that event before the batch is handed over, and every tensor is
`record_stream`-ed onto the consuming stream, so the caching allocator
cannot give its memory to a later copy while a step still reads it. On
the CPU a batch is placed with `torch.as_tensor`.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from hsenet_torch.utils.profiling import span


# the producer thread's name
PRODUCER_NAME = "DevicePrefetcher"


def host_arrays(batch: dict) -> Dict[str, np.ndarray]:
    """The array fields of a host batch (strings and lists are left out)."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


class CudaPlacer:
    """Place host batches on a CUDA device from a side stream: pinned
    host copies, asynchronous copies, an event per batch."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, batch: dict):
        arrays = host_arrays(batch)
        with torch.cuda.stream(self.stream):
            placed = {k: torch.as_tensor(v).pin_memory().to(self.device, non_blocking=True)
                      for k, v in arrays.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return placed, done

    def hand_over(self, item) -> Dict[str, torch.Tensor]:
        """On the consumer's thread: make its current stream wait for the
        copies, and tie each tensor's memory to that stream."""
        placed, done = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in placed.values():
            t.record_stream(stream)
        return placed


def default_place(batch: dict, device) -> Dict[str, torch.Tensor]:
    """Array fields -> tensors on `device` (a plain copy)."""
    return {k: torch.as_tensor(v).to(device) for k, v in host_arrays(batch).items()}


class DevicePrefetcher:
    """Iterate `loader`, keeping up to `depth` batches already on `device`.

    `place` maps a host batch to a device batch (default: `CudaPlacer` on a
    CUDA device, `default_place` elsewhere). An exception in the producer
    re-raises in the consumer. Closing the iterator (break, gc) stops the
    producer; batches placed and not consumed are dropped, which is safe
    because placement has no side effects.
    """

    def __init__(self, loader: Iterable[dict], depth: int = 2, device="cpu",
                 place: Optional[Callable[[dict], dict]] = None):
        self.loader = loader
        self.depth = max(int(depth), 1)
        self.device = torch.device(device)
        self.place = place
        self.hand_over = None
        if place is None:
            if self.device.type == "cuda":
                placer = CudaPlacer(self.device)
                self.place, self.hand_over = placer, placer.hand_over
            else:
                self.place = lambda b: default_place(b, self.device)

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def produce():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        return
                    q.put(self.place(batch))
                q.put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                q.put(e)

        t = threading.Thread(target=produce, name=PRODUCER_NAME, daemon=True)
        t.start()
        try:
            while True:
                with span("data.wait"):
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    batch = self.hand_over(item) if self.hand_over else item
                yield batch
        finally:
            stop.set()
            # bounded drain: a producer blocked inside the loader's
            # __next__ (stalled upstream) is given up after a few joins; it
            # is a daemon thread, so abandoning it is safe
            for _ in range(20):
                if not t.is_alive():
                    break
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
