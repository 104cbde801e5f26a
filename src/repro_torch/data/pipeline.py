"""Streaming input pipeline — the paper's Emitter, feeding the train loop.

Counterpart of ``repro.data.pipeline``.  A producer thread (the Emitter)
materialises batches and pushes them through the port's lock-free SPSC
ring (``repro_torch.core.spsc``); the training loop (the Worker) pops them
and moves them to the device while the Emitter prepares the next batch.

The batches are numpy arrays, a pure function of (seed, step), drawn as
the reference draws them: after a checkpoint restore at step k the
pipeline resumes exactly, and the port's batches equal the reference's
bit for bit.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from ..core.spsc import EOS, SPSCQueue
from ..models.config import ModelConfig

__all__ = ["SyntheticLM", "StreamingPipeline", "make_batch_stream"]


class SyntheticLM:
    """Deterministic synthetic LM batches: batch(step) is a pure function."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        cfg = self.cfg
        if cfg.family == "audio":
            out = {
                "frames": rng.standard_normal(
                    (self.batch, self.seq, cfg.d_model), dtype=np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (self.batch, cfg.n_codebooks, self.seq),
                                       dtype=np.int32),
            }
        else:
            toks = rng.integers(0, cfg.vocab_size, (self.batch, self.seq + 1),
                                dtype=np.int32)
            out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "vlm":
            out["vision_embeds"] = rng.standard_normal(
                (self.batch, cfg.vision_patches, cfg.vision_dim)).astype(np.float32)
        return out


class StreamingPipeline:
    """Emitter-thread batch producer over an SPSC ring (capacity = prefetch).
    Iterating yields (step, batch) in step order."""

    def __init__(self, source: Callable[[int], Dict], start_step: int = 0,
                 prefetch: int = 2, n_steps: Optional[int] = None):
        self.source = source
        self.start_step = start_step
        self.n_steps = n_steps
        self._ring = SPSCQueue(max(2, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._emit, name="data-emitter",
                                        daemon=True)
        self._thread.start()

    def _emit(self) -> None:
        step = self.start_step
        while not self._stop.is_set():
            if self.n_steps is not None and step >= self.start_step + self.n_steps:
                break
            batch = self.source(step)
            while not self._ring.push((step, batch)):
                if self._stop.is_set():
                    return
                self._stop.wait(0.0005)
            step += 1
        self._ring.push_wait(EOS)

    def __iter__(self) -> Iterator:
        while True:
            item = self._ring.pop_wait(timeout=30.0)
            if item is EOS or item is SPSCQueue._EMPTY:
                return
            yield item

    def close(self) -> None:
        self._stop.set()


def make_batch_stream(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                      start_step: int = 0, n_steps: Optional[int] = None,
                      prefetch: int = 2) -> StreamingPipeline:
    return StreamingPipeline(SyntheticLM(cfg, batch, seq, seed),
                             start_step=start_step, n_steps=n_steps,
                             prefetch=prefetch)
