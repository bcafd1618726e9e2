"""Prefetching, resumable dataloader (port of
fastvideo_tpu/dataset/loader.py).

A background thread builds batches ahead of the training step, so the
host's input work overlaps the device's. ``state_dict`` /
``load_state_dict`` resume mid-epoch by (epoch, batch index) without
rebuilding the skipped batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable


class PrefetchingLoader:
    """A ``make_batch(indices) -> batch`` function over a batch sampler,
    as a prefetching iterator.

    The sampler must be re-iterable and deterministic given its state
    (``DPSPBatchSampler``); resume skips sampler index lists (cheap), not
    built batches (expensive).
    """

    def __init__(self, sampler, make_batch: Callable[[list[int]], Any],
                 prefetch: int = 2):
        self.sampler = sampler
        self.make_batch = make_batch
        self.prefetch = max(1, int(prefetch))
        self._batch_in_epoch = 0
        self._epoch = 0
        self._skip = 0
        self._thread: threading.Thread | None = None
        self._q: queue.Queue | None = None
        self._stop = threading.Event()

    # -- iteration -----------------------------------------------------------

    def _producer(self) -> None:
        try:
            while not self._stop.is_set():
                produced = 0
                epoch = getattr(self.sampler, "epoch", 0)
                for i, indices in enumerate(self.sampler):
                    if self._stop.is_set():
                        return
                    if i < self._skip:
                        continue  # resume fast-forward: nothing is built
                    batch = self.make_batch(indices)
                    # blocks while `prefetch` batches wait: bounded memory
                    while not self._stop.is_set():
                        try:
                            self._q.put((epoch, i, batch), timeout=0.5)
                            produced += 1
                            break
                        except queue.Full:
                            continue
                if self._skip == 0 and produced == 0:
                    self._q.put(None)  # an empty sampler ends iteration
                    return
                self._skip = 0
        except Exception as e:  # handed to the consumer, raised there
            self._q.put(e)

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._q = queue.Queue(maxsize=self.prefetch)
            self._stop.clear()
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        self._ensure_thread()
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        epoch, i, batch = item
        self._epoch = epoch
        self._batch_in_epoch = i + 1
        return batch

    def shutdown(self) -> None:
        """Stop the producer thread and wait for it."""
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- resume ----------------------------------------------------------------

    def state_dict(self) -> dict:
        """The consumer's position: the epoch and index of the last batch
        the trainer received (prefetched batches in flight replay on
        resume)."""
        state = {"batch_in_epoch": self._batch_in_epoch,
                 "epoch": self._epoch}
        if hasattr(self.sampler, "state_dict"):
            state["sampler"] = self.sampler.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        self.shutdown()
        self._thread = None
        if "sampler" in state and hasattr(self.sampler, "load_state_dict"):
            self.sampler.load_state_dict(state["sampler"])
        if hasattr(self.sampler, "epoch"):
            # resume inside the epoch the consumer last saw
            self.sampler.epoch = int(state.get("epoch", 0))
        self._skip = int(state.get("batch_in_epoch", 0))
        self._batch_in_epoch = self._skip
