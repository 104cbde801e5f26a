"""The port's macro data-flow executor (paper Sec. 5) against the JAX
package's, on the CPU.

The port's form of tests/test_farm.py:115 (wavefront dependencies
respected), the same results dict as ``repro.core.mdf.MDFExecutor`` on a
seeded random DAG, and blocked Smith-Waterman as a wavefront dynamic
program over numpy affine-gap tiles, whose best score equals the port's
``ops.smith_waterman`` and the JAX package's, exactly (integer scores).
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.mdf import MDFExecutor as JMDFExecutor
from repro.core.mdf import MDFTask as JMDFTask
from repro.kernels import ops as jops
from repro_torch.core import MDFExecutor, MDFTask
from repro_torch.kernels import ops

NEG = -1e9


@pytest.mark.parametrize("nworkers", [1, 4])
def test_mdf_wavefront_dependencies_respected(nworkers):
    order = []
    lock = threading.Lock()

    def record(*deps, tag=None):
        with lock:
            order.append(tag)
        return sum(deps) + 1

    n = 5
    tasks = []
    for i in range(n):
        for j in range(n):
            deps = tuple(t for t in [(i - 1, j), (i, j - 1)]
                         if t[0] >= 0 and t[1] >= 0)
            tasks.append(MDFTask(tag=(i, j), fn=lambda *d, tag=(i, j): record(*d, tag=tag),
                                 deps=deps))
    out = MDFExecutor(nworkers=nworkers).run(tasks)
    assert len(out) == n * n
    pos = {t: i for i, t in enumerate(order)}
    for i in range(n):
        for j in range(n):
            if i:
                assert pos[(i - 1, j)] < pos[(i, j)]
            if j:
                assert pos[(i, j - 1)] < pos[(i, j)]
    # each cell is 1 + the sum of its dependencies, on every schedule
    assert out[(n - 1, n - 1)] == out[(n - 1, n - 2)] + out[(n - 2, n - 1)] + 1


def _random_dag(seed, n=60):
    """Tags 0..n-1; each task depends on up to 3 earlier tasks."""
    rng = np.random.default_rng(seed)
    deps = []
    for t in range(n):
        k = int(rng.integers(0, min(t, 3) + 1))
        deps.append(tuple(int(d) for d in rng.choice(t, k, replace=False)) if k else ())
    extra = [int(v) for v in rng.integers(1, 1000, n)]
    return deps, extra


def _node(*args):
    """Deterministic in its arguments' order: deps' results, then extra."""
    acc = 17
    for a in args:
        acc = (acc * 31 + a) % 1_000_003
    return acc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mdf_results_equal_the_reference_on_a_random_dag(seed):
    deps, extra = _random_dag(seed)
    got = MDFExecutor(nworkers=3).run(
        [MDFTask(tag=t, fn=_node, deps=d, extra_args=(e,))
         for t, (d, e) in enumerate(zip(deps, extra))])
    want = JMDFExecutor(nworkers=3).run(
        [JMDFTask(tag=t, fn=_node, deps=d, extra_args=(e,))
         for t, (d, e) in enumerate(zip(deps, extra))])
    assert got == want
    assert len(got) == len(deps)


def test_mdf_refuses_malformed_graphs():
    with pytest.raises(ValueError, match="duplicate"):
        MDFExecutor().run([MDFTask(tag=0, fn=int), MDFTask(tag=0, fn=int)])
    with pytest.raises(ValueError, match="unknown dep"):
        MDFExecutor().run([MDFTask(tag=0, fn=int, deps=(9,))])


# -- blocked Smith-Waterman as a wavefront (paper Sec. 5) ---------------------
def _tile(top, left, scores, go, ge):
    """One (rows × cols) tile of the affine-gap SW recurrence, the form of
    ``kernels/ref.py::sw_numpy``.  ``top`` = (H row above, cols + 1 values
    with the corner first; F row above), ``left`` = (H column left; E
    column left).  Returns the tile's edges for its neighbours and its best."""
    rows, cols = scores.shape
    H = np.zeros((rows + 1, cols + 1))
    E = np.full((rows + 1, cols + 1), NEG)
    F = np.full((rows + 1, cols + 1), NEG)
    H[0, :], F[0, 1:] = top
    H[1:, 0], E[1:, 0] = left
    for i in range(1, rows + 1):
        for j in range(1, cols + 1):
            E[i, j] = max(H[i, j - 1] - go, E[i, j - 1] - ge)
            F[i, j] = max(H[i - 1, j] - go, F[i - 1, j] - ge)
            H[i, j] = max(0.0, H[i - 1, j - 1] + scores[i - 1, j - 1],
                          E[i, j], F[i, j])
    return {"bottom": (H[rows, :].copy(), F[rows, 1:].copy()),
            "right": (H[1:, cols].copy(), E[1:, cols].copy()),
            "best": float(H[1:, 1:].max())}


def _blocked_sw(query, subject, tile, go, ge, nworkers):
    m = ops.BLOSUM50.numpy().astype(np.float64)
    scores = m[np.asarray(query)[:, None], np.asarray(subject)[None, :]]
    rb = range(0, len(query), tile)
    cb = range(0, len(subject), tile)
    tasks = []
    for bi, r0 in enumerate(rb):
        for bj, c0 in enumerate(cb):
            rows, cols = min(tile, len(query) - r0), min(tile, len(subject) - c0)
            deps = tuple(t for t in [(bi - 1, bj), (bi, bj - 1)] if min(t) >= 0)

            def fn(*got, bi=bi, bj=bj, r0=r0, c0=c0, rows=rows, cols=cols):
                got = list(got)
                if bi:
                    top = got.pop(0)["bottom"]
                else:
                    top = (np.zeros(cols + 1), np.full(cols, NEG))
                if bj:
                    left = got.pop(0)["right"]
                else:
                    left = (np.zeros(rows), np.full(rows, NEG))
                # the corner H[r0-1, c0-1] rides at the front of the row above
                return _tile(top, left, scores[r0:r0 + rows, c0:c0 + cols], go, ge)
            tasks.append(MDFTask(tag=(bi, bj), fn=fn, deps=deps))
    out = MDFExecutor(nworkers=nworkers).run(tasks)
    assert len(out) == len(rb) * len(cb)
    return max(r["best"] for r in out.values())


@pytest.mark.parametrize("qlen,dlen,tile", [(97, 131, 32), (40, 40, 16),
                                            (33, 200, 64)])
@pytest.mark.parametrize("gaps", [(10.0, 2.0), (5.0, 2.0)])
def test_blocked_smith_waterman_wavefront_equals_both_kernels(qlen, dlen, tile, gaps):
    rng = np.random.default_rng(qlen * 1000 + dlen)
    query = rng.integers(0, 20, qlen).astype(np.int32)
    subject = rng.integers(0, 20, dlen).astype(np.int32)
    go, ge = gaps
    best = _blocked_sw(query, subject, tile, go, ge, nworkers=3)
    port = float(ops.smith_waterman(query, subject, gap_open=go, gap_extend=ge,
                                    tile=64, device="cpu"))
    jax_ = float(jops.smith_waterman(jnp.asarray(query), jnp.asarray(subject),
                                     gap_open=go, gap_extend=ge, tile=64))
    assert best == port == jax_
    assert best > 0


def test_blocked_tiles_carry_the_corner():
    """A diagonal-only alignment that crosses a tile corner: the score must
    flow through H[r0-1, c0-1], which no direct dependency computes."""
    seq = ops.encode_seq("WWWWWWWW", device="cpu").numpy()           # W·W = 15 in BLOSUM50
    best = _blocked_sw(seq, seq, 4, 10.0, 2.0, nworkers=2)
    assert best == 15.0 * 8
    assert best == float(ops.smith_waterman(seq, seq, tile=64, device="cpu"))
