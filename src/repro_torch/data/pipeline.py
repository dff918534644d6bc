"""Deterministic synthetic data pipeline with prefetch.

Counterpart of the reference package's ``data/pipeline.py``, in NumPy
as there: every batch is keyed by (seed, step, host), so a run resumed
at step N reads the same token stream, and batches equal the
reference's bit for bit.  A background thread keeps a double buffer of
batches ahead of the training loop.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


class SyntheticLM:
    """Zipfian token stream with a learnable bigram structure (so a real
    model shows decreasing loss within a few hundred steps)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 microbatches: int = 1, num_hosts: int = 1,
                 host_id: int = 0) -> None:
        self.cfg, self.shape = cfg, shape
        self.seed = seed
        self.micro = microbatches
        self.num_hosts, self.host_id = num_hosts, host_id
        if not (shape.global_batch % (num_hosts * microbatches) == 0
                or shape.global_batch >= num_hosts):
            raise ValueError(
                f"global batch {shape.global_batch} does not split over "
                f"{num_hosts} hosts x {microbatches} microbatches")
        self.local_batch = max(shape.global_batch // num_hosts, 1)
        # fixed random bigram transition "language"
        rng = np.random.default_rng(seed)
        v = cfg.vocab
        self._next = rng.integers(0, v, size=(v,), dtype=np.int32)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """``tokens`` and ``labels`` [micro, local_batch / micro, S] int32
        (``embeds`` in place of ``tokens`` for the vision stub, plus
        ``enc_embeds`` for an encoder-decoder, float32 [..., S, D])."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.host_id)
        b, s, v = self.local_batch, self.shape.seq_len, self.cfg.vocab
        # start tokens ~ zipf-ish; sequence follows the noisy bigram chain
        x = np.empty((b, s + 1), np.int32)
        x[:, 0] = rng.integers(0, v, size=b)
        noise = rng.random((b, s)) < 0.1
        rand_tok = rng.integers(0, v, size=(b, s), dtype=np.int32)
        for t in range(s):
            nxt = self._next[x[:, t]]
            x[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        tokens, labels = x[:, :-1], x[:, 1:].copy()
        m = self.micro
        out = {
            "tokens": tokens.reshape(m, b // m, s),
            "labels": labels.reshape(m, b // m, s),
        }
        if self.cfg.frontend == "vision_stub":
            emb = rng.standard_normal(
                (m, b // m, s, self.cfg.d_model)).astype(np.float32) * 0.02
            out = {"embeds": emb, "labels": out["labels"]}
        if self.cfg.enc_dec:
            enc = rng.standard_normal(
                (m, b // m, s, self.cfg.d_model)).astype(np.float32) * 0.02
            out["enc_embeds"] = enc
        return out


class Prefetcher:
    """Double-buffered background batch producer: ``next()`` returns
    (step, batch) for ``start_step``, ``start_step + 1``, ..."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2) -> None:
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
