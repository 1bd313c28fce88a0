"""Deterministic synthetic LM data and its prefetcher (PyTorch port of
``repro.data.pipeline``).

``SyntheticLMStream`` gives the same tokens for the same (seed, step) as
the reference's, from ``np.random.default_rng((seed, step))``, with labels
= tokens rolled left by one, so a restart replays exactly the batches
after the restored step.  Batches are numpy on the host; every rank makes
the same one and keeps its block in the step.

``Prefetcher`` makes the batches of the next steps on a thread and copies
them to the device ahead of the step that reads them.  On the card each
copy runs on a side stream from pinned memory; the consumer's stream
waits on the copy's event before the step reads the batch (or a step
could read a half-copied batch), and each batch tensor is marked used on
that stream (``record_stream``), or the caching allocator could hand its
memory to the next copy while the step still reads it.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch


class SyntheticLMStream:
    """Deterministic tokens: tokens[step] = default_rng((seed, step))
    integers in [0, vocab) of shape [global_batch, seq_len]."""

    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 *, seed: int = 0):
        self.vocab = vocab_size
        self.B = global_batch
        self.S = seq_len
        self.seed = seed

    def _tokens_for(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        return rng.integers(0, self.vocab, (self.B, self.S), dtype=np.int32)

    def batch(self, step: int) -> dict:
        tok = self._tokens_for(step)
        return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


class Prefetcher:
    """The batches of steps ``start_step``, ``start_step + 1``, ... of
    ``stream`` on ``device``, made ``depth`` steps ahead on a thread.
    ``next()`` returns ``(step, {name: tensor})`` in step order; ``stop()``
    ends the thread."""

    def __init__(self, stream, device, start_step: int = 0, depth: int = 2):
        self.stream = stream
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.copy_stream = (torch.cuda.Stream(self.device) if self.cuda
                            else None)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _to_device(self, host: dict):
        """(tensors, the copy's event or None)."""
        if not self.cuda:
            return {k: torch.from_numpy(v) for k, v in host.items()}, None
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.copy_stream):
            dev = {k: torch.from_numpy(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        return dev, event

    def _run(self):
        step = self._step
        try:
            while not self._stop.is_set():
                item = (step, self._to_device(self.stream.batch(step)))
                while True:
                    try:
                        self.q.put(item, timeout=1.0)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            return
                step += 1
        except BaseException as e:  # re-raised by the consumer's next()
            self._exc = e

    def next(self, timeout: float = 60.0):
        """The next step's batch, waiting at most ``timeout`` seconds
        (TimeoutError); a failure of the producer thread is re-raised at
        once, and again by every later call."""
        deadline = time.monotonic() + timeout
        while True:
            if self._exc is not None and self.q.empty():
                raise self._exc
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"prefetcher produced no batch within {timeout:.1f}s")
            try:
                step, (dev, event) = self.q.get(timeout=min(0.2, remaining))
            except queue.Empty:
                continue
            if event is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(event)
                for t in dev.values():
                    t.record_stream(current)
            return step, dev

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
