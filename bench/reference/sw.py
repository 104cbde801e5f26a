"""Plain Smith-Waterman-Gotoh local alignment scores, for judging a search.

The textbook recurrence with affine gaps (a gap of k characters costs
open + (k - 1) x extend):

    E(i,j) = max(H(i,j-1) - open, E(i,j-1) - extend)
    F(i,j) = max(H(i-1,j) - open, F(i-1,j) - extend)
    H(i,j) = max(0, H(i-1,j-1) + M[q_i, s_j], E(i,j), F(i,j))

and the score is the largest H over the query and subject cells.  It is
swept along anti-diagonals (cells with i + j = d depend only on diagonals
d - 1 and d - 2), vectorised over every (query, subject) pair at once.  It
imports nothing of the program and holds its own copy of BLOSUM50.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import torch

_HERE = Path(__file__).resolve().parent


def blosum50() -> torch.Tensor:
    """(24, 24) f32 in the alphabet's order ARNDCQEGHILKMFPSTWYVBZX*."""
    rows = [line.split() for line in (_HERE / "blosum50.txt").read_text().splitlines()
            if line and not line.startswith("#")]
    return torch.tensor([[float(v) for v in r] for r in rows])


def sw_scores(queries: Sequence[torch.Tensor], gaps: Sequence[Tuple[float, float]],
              subjects: torch.Tensor, lengths: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Scores (len(queries), N) of every query against every subject.

    queries: int code tensors; gaps: (open, extend) per query; subjects:
    (N, Dmax) int codes, row n valid up to ``lengths[n]``.  Computed in
    ``dtype`` throughout, on the subjects' device."""
    dev = subjects.device
    M = blosum50().to(dev, dtype)
    A = M.shape[0]
    nq, N = len(queries), subjects.shape[0]
    Dmax = subjects.shape[1]
    Qmax = max(int(q.shape[0]) for q in queries)
    R, W = nq * N, Qmax + 1                      # rows; i = 0..Qmax

    def per_row(vals, dt):
        return torch.tensor(vals, dtype=dt, device=dev).repeat_interleave(N)[:, None]

    go = per_row([g[0] for g in gaps], dtype)
    ge = per_row([g[1] for g in gaps], dtype)
    qlen = per_row([int(q.shape[0]) for q in queries], torch.long)
    # row r's query code at i (i >= 1), times A: M.flatten()[qa + s] = M[q_i, s]
    qa = torch.zeros((nq, W), dtype=torch.long, device=dev)
    for k, q in enumerate(queries):
        qa[k, 1:q.shape[0] + 1] = q.to(dev).long() * A
    qa = qa.repeat_interleave(N, 0)
    Mf = M.flatten()
    subj = subjects.long().clamp(0, A - 1).repeat(nq, 1)             # (R, Dmax)
    slen = lengths.to(dev).long().repeat(nq)[:, None]
    i = torch.arange(W, device=dev)[None, :]

    # each diagonal's H, E, F with one leading column for i = -1, which
    # stays at H = 0, E = F = -inf: column c holds i = c - 1
    def plane(fill):
        return torch.full((R, W + 1), fill, dtype=dtype, device=dev)
    h2, h1, h0 = plane(0.0), plane(0.0), plane(0.0)
    e1, e0 = plane(float("-inf")), plane(float("-inf"))
    f1, f0 = plane(float("-inf")), plane(float("-inf"))
    zero = torch.zeros((), dtype=dtype, device=dev)
    neg = torch.tensor(float("-inf"), dtype=dtype, device=dev)
    best = torch.zeros((R,), dtype=dtype, device=dev)
    at, up = slice(1, W + 1), slice(0, W)          # i, and i - 1
    for d in range(2, Qmax + Dmax + 1):
        j = d - i
        inside = (i >= 1) & (j >= 1) & (j <= Dmax)
        s = Mf[qa + subj.gather(1, (j - 1).clamp(0, Dmax - 1).expand(R, -1))]
        e = torch.maximum(h1[:, at] - go, e1[:, at] - ge)
        f = torch.maximum(h1[:, up] - go, f1[:, up] - ge)
        h = torch.maximum(torch.maximum(h2[:, up] + s, zero), torch.maximum(e, f))
        torch.where(inside, h, zero, out=h0[:, at])
        torch.where(inside, e, neg, out=e0[:, at])
        torch.where(inside, f, neg, out=f0[:, at])
        live = inside & (i <= qlen) & (j <= slen)
        best = torch.maximum(best, torch.where(live, h0[:, at], zero).amax(1))
        h2, h1, h0 = h1, h0, h2
        e1, e0 = e0, e1
        f1, f0 = f0, f1
    return best.reshape(nq, N)


def gather_subjects(flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
                    pad: int) -> torch.Tensor:
    """(N, max length) int32 codes of the subjects at ``offsets`` in the
    flat residue array, padded with ``pad``."""
    Dmax = int(lengths.max())
    col = torch.arange(Dmax, device=flat.device)[None, :]
    idx = (offsets[:, None] + col).clamp(max=flat.numel() - 1)
    return torch.where(col < lengths[:, None], flat[idx], pad).to(torch.int32)


def worst_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| (inf where either is not finite)."""
    diff = (got.double() - want.double()).abs()
    return float("inf") if not torch.isfinite(diff).all() else float(diff.max())


def pick(n: int, edges: List[int], count: int, gen: torch.Generator) -> torch.Tensor:
    """``edges`` and ``count - len(edges)`` more of range(n), drawn with
    ``gen``, sorted, distinct."""
    rest = torch.ones(n, dtype=torch.bool)
    rest[torch.tensor(edges, dtype=torch.long)] = False
    others = torch.nonzero(rest)[:, 0]
    extra = others[torch.randperm(others.numel(), generator=gen)[:max(0, count - len(edges))]]
    return torch.cat([torch.tensor(edges, dtype=torch.long), extra]).unique()
