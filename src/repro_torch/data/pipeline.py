"""Deterministic synthetic token pipeline with a prefetching thread.

The port of ``repro/data/pipeline.py``.  :class:`SyntheticLM` is the
reference's numpy generator, copied: ``batch_at(step)`` is a pure function
of (seed, step), so a restart resumes mid-stream with no batch lost or
repeated (what ``runtime.trainer`` relies on), and its tokens and frontend
embeddings are the reference's bit for bit.  :class:`Prefetcher` is a
thread that keeps ``depth`` batches ahead on the device: each batch's
arrays become tensors in pinned host memory and go to a CUDA device with a
``non_blocking`` copy (plain copies to the CPU).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ArchConfig


class SyntheticLM:
    """Zipfian token stream with short-range structure (next-token
    learnable: t_{i+1} depends on t_i via a fixed permutation + noise), so
    training shows a real loss drop."""

    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int,
                 seed: int = 0, noise: float = 0.1):
        self.cfg = cfg
        self.batch = batch
        s_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
        self.seq_len = seq_len - s_front
        self.s_front = s_front
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(cfg.vocab_size)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self.p = p / p.sum()

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step): the resumability contract."""
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch, self.seq_len, self.cfg.vocab_size
        first = rng.choice(V, size=(B, 1), p=self.p)
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = first[:, 0]
        flip = rng.random((B, S)) < self.noise
        rand = rng.choice(V, size=(B, S), p=self.p)
        for i in range(1, S):
            nxt = self.perm[toks[:, i - 1]]
            toks[:, i] = np.where(flip[:, i], rand[:, i], nxt)
        out = {"tokens": toks}
        if self.s_front:
            out["embeddings"] = rng.standard_normal(
                (B, self.s_front, self.cfg.d_model)).astype(np.float32) * 0.02
        return out

    def stream(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """A thread that puts the batches of ``it`` on ``device`` (default the
    card), ``depth`` ahead; ``close()`` stops it and waits for it."""

    def __init__(self, it: Iterator[dict], depth: int = 2, device="cuda"):
        self.it = it
        self.device = resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _put(self, item) -> bool:
        """Queue ``item`` unless stopped; False once stopped."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                if not self._put({k: self._to_device(v)
                                  for k, v in item.items()}):
                    return
        finally:
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self.t.join(timeout)
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
