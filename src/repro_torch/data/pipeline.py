"""Deterministic, restart-safe data pipeline: the port's own copy of the
reference's ``data/pipeline.py`` (numpy only; the same batches, array for
array, for every ``(seed, step, host_id, num_hosts)``).

Every batch is a pure function of ``(step, host_id)`` — no iterator state, no
shuffle buffers. Consequences for fault tolerance:

* a restarted (or elastically re-sharded) job resumes at step k and sees
  exactly the batches it would have seen — no data loss or duplication;
* stragglers can't skew data order: there is no inter-host coordination;
* the pipeline itself needs no checkpoint state beyond the step counter.

The synthetic corpus is a seeded Zipfian token stream with local n-gram
structure (so models actually learn and loss decreases in the examples).
A background prefetch thread keeps ``depth`` batches in flight; its
``transform`` (such as a move onto the card) runs in that thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticLM", "Prefetcher"]


class SyntheticLM:
    """Deterministic synthetic LM corpus: batch = f(seed, step, host)."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1):
        assert batch % num_hosts == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        # a fixed random "bigram table" gives the stream learnable structure
        rng = np.random.default_rng(seed ^ 0xC0FFEE)
        self.next_tok = rng.integers(0, vocab, size=(vocab, 4))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        b, s = self.local_batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        noise = rng.random((b, s))
        branch = rng.integers(0, 4, (b, s))
        rand_tok = rng.integers(0, self.vocab, (b, s))
        for t in range(s):
            follow = self.next_tok[toks[:, t], branch[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.8, follow, rand_tok[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


class Prefetcher:
    """Double-buffered background prefetch of a (step -> batch) source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 transform=None):
        self.source = source
        self.transform = transform or (lambda x: x)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.transform(self.source.batch_at(step))
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
