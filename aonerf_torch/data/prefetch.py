"""A thread that assembles host batches ahead of the train step
(counterpart of ``aonerf.data.prefetch``).

The auto-encoder's host-batched step needs each batch's whole source image,
assembled on the host (``SapienMultiDataset.sample_train``); the prefetcher
overlaps that with the device's work. The worker makes numpy batches only
and touches no CUDA tensor: the caller copies each batch to the device.
"""

import queue
import threading
from typing import Callable, Optional


class Prefetcher:
    """Runs ``make_batch()`` in a daemon thread, keeping up to ``depth``
    ready batches, in the order made. An exception of the worker is raised
    again by every ``get()`` after it; ``close()`` stops the thread and joins it."""

    def __init__(self, make_batch: Callable[[], dict], depth: int = 2):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                batch = self._make()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # raised again by the next get()
            self._exc = e

    def get(self, timeout: float = 60.0) -> dict:
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                timeout -= 0.5
                if timeout <= 0:
                    raise TimeoutError("prefetcher produced no batch in time")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
