"""The general generators: every input of a run is a function of
``--seed`` and of the parameters in a configuration or traffic file.

* ``swissprot_db``: a protein database drawn to a Swiss-Prot release's
  statistics (``chip_smoke.make_big_db``'s draws: gamma lengths clipped to
  a range, residues uniform over the 20 standard amino acids), the
  lengths on the host and the residues on the device in one call;
* ``QuerySchedule``: the closed loop's queries, each (length, gap regime)
  of the mix once per block in an order drawn from the seed, so every
  seed sends the same sizes in another order;
* ``lm_batch``: a language-model batch as a pure function of (seed,
  step): a frozen copy of the program's ``data.SyntheticLM`` draws, for
  the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

RESIDUES = 20        # the standard amino acids, codes 0-19 of the alphabet


def seed64(seed: int) -> int:
    """``--seed`` as the unsigned 64-bit seed every generator here takes."""
    return int(seed) % (1 << 64)


def swissprot_lengths(db: Dict[str, Any], seed: int) -> np.ndarray:
    """``db["subjects"]`` lengths: gamma(shape, mean/shape) clipped to
    [min_len, max_len], as int64."""
    rng = np.random.default_rng(seed64(seed))
    lens = rng.gamma(db["gamma_shape"], db["mean_len"] / db["gamma_shape"],
                     db["subjects"]).astype(np.int64)
    return np.clip(lens, db["min_len"], db["max_len"])


def swissprot_db(db: Dict[str, Any], seed: int, device) -> Tuple[torch.Tensor, np.ndarray]:
    """(residues as one int32 tensor on ``device``, lengths (host int64))."""
    lens = swissprot_lengths(db, seed)
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    flat = torch.randint(0, RESIDUES, (int(lens.sum()),), generator=gen,
                         dtype=torch.int32, device=device)
    return flat, lens


class QuerySchedule:
    """Query ``i`` of a run: (length, gap_open, gap_extend, residues as an
    int32 numpy array).  ``traffic["query_lengths"]`` x
    ``traffic["gap_regimes"]`` ([open, extend] pairs) in blocks, each block
    one permutation drawn from (seed, block)."""

    def __init__(self, traffic: Dict[str, Any], seed: int) -> None:
        self.combos = [(int(q), float(go), float(ge))
                       for q in traffic["query_lengths"]
                       for go, ge in traffic["gap_regimes"]]
        self.seed = seed64(seed)
        self._perms: Dict[int, np.ndarray] = {}

    def __call__(self, i: int) -> Tuple[int, float, float, np.ndarray]:
        n = len(self.combos)
        block = i // n
        if block not in self._perms:
            self._perms[block] = np.random.default_rng(
                [self.seed, 1, block]).permutation(n)
        q, go, ge = self.combos[self._perms[block][i % n]]
        res = np.random.default_rng([self.seed, 2, i]).integers(
            0, RESIDUES, q, dtype=np.int32)
        return q, go, ge, res

    def lengths(self) -> List[int]:
        return sorted({q for q, _, _ in self.combos})


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int
             ) -> Dict[str, np.ndarray]:
    """Tokens and next-token labels, (batch, seq) int32 each: the draws of
    the program's ``SyntheticLM`` for a text model."""
    rng = np.random.default_rng((seed, step))
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
