"""Dynamic request batching for the synthesis server.

Parity target: the reference's GPU serving gets cross-request batching
from Triton's dynamic batcher (runtime/gpu_triton/model_repo/tts/config.pbtxt
`dynamic_batching { max_queue_delay_microseconds: ... }`); the C++ HTTP
server runs one synthesis per request. Here the batcher sits between the
HTTP handlers and the engine: concurrent requests arriving within a short
window are dispatched as one batch, one engine call, so the device's
utilization scales with load instead of per-request latency.

The port's own copy of `wetts_tpu/serving/batcher.py`. The JAX engine pads
a batch up to a bucket of (1, 2, 4, 8) so that few executables compile; the
port's engine has no compiled executables to reuse and synthesizes a batch
as it comes, so only the largest bucket, MAX_BATCH, is kept: the most
requests one engine call takes (larger batches are split there).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from wetts_tpu_torch.text.segmenter import sentence_segment

MAX_BATCH = 8


class DynamicBatcher:
    """Collects concurrent synthesis requests into batches.

    max_batch: largest batch dispatched at once.
    max_delay_s: how long the dispatcher waits after the first queued
    request for more to arrive (Triton's max_queue_delay analog).
    batch_sizes: the size of every batch dispatched, in order.
    """

    def __init__(self, engine, max_batch: int = MAX_BATCH,
                 max_delay_s: float = 0.005):
        self.engine = engine
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.batch_sizes: list = []
        self._queue: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._stop = threading.Event()
        self._thread.start()

    def submit(self, ids: Sequence[int], sid: int) -> Future:
        if self._stop.is_set():
            raise RuntimeError("batcher shut down")
        fut: Future = Future()
        self._queue.put((list(ids), sid, fut))
        return fut

    def synthesize(self, text: str, speaker: Optional[str] = None
                   ) -> np.ndarray:
        """Drop-in for engine.synthesize, routed through the batcher."""
        from wetts_tpu_torch.serving.engine import MAX_CLAUSE_LEN

        sid = self.engine.speaker_id(speaker)
        futures = []
        for sentence in sentence_segment(text, MAX_CLAUSE_LEN) or [text]:
            ids = self.engine.text_to_phone_ids(sentence)
            if ids:
                futures.append(self.submit(ids, sid))
        pieces = [f.result() for f in futures]
        if not pieces:
            return np.zeros((0,), np.float32)
        return np.concatenate(pieces)

    def shutdown(self):
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=5)
        # fail any requests still queued (or racing the shutdown) so their
        # callers don't block forever in fut.result()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[2].done():
                item[2].set_exception(RuntimeError("batcher shut down"))

    # -- dispatcher ------------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            item = self._queue.get()
            if item is None:
                continue
            batch = [item]
            # linger for co-arriving requests: one fixed window starting at
            # first-item arrival (Triton's max_queue_delay semantics), NOT
            # restarted per dequeued item
            deadline = time.monotonic() + self.max_delay_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            self.batch_sizes.append(len(batch))
            try:
                audios = self.engine.synthesize_ids_batch(
                    [b[0] for b in batch], [b[1] for b in batch])
                for (_, _, fut), audio in zip(batch, audios):
                    fut.set_result(audio)
            except Exception as e:  # noqa: BLE001
                for (_, _, fut) in batch:
                    if not fut.done():
                        fut.set_exception(e)
        # drain anything enqueued between the last get and _stop
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[2].done():
                item[2].set_exception(RuntimeError("batcher shut down"))
