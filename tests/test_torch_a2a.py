"""The port's keyed shuffle (``repro_torch.core.a2a``) and streaming
operators (``repro_torch.core.stream_ops``) against the reference's: the
same ``AllToAll`` / ``reduce_by_key`` / ``partition_by`` / ``window``
skeleton, built in each package from the same nodes, gives the same
result on the port's threads and procs backends as on the reference's
threads backend (dicts or sorted lists, where the reference compares
them so): EOS fan-in on an N×M matrix, key affinity across processes,
ordered shuffles, composition in pipelines, the fuse boundary, the
``KeyAffinity`` policy and the error contracts.  ``stable_hash`` gives the
reference's digest on a property sweep over every key type it accepts
and refuses tensors and numpy scalars alike.  Last, the keyed aggregation
of score tensors that ``chip_smoke.py`` runs on the card, at a small size
on the CPU."""
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import _procs_nodes as N
import _torch_procs_nodes as T
import repro.core as jcore
import repro_torch.core as tcore
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import (AllToAll, Farm, FnNode, KeyAffinity,
                              LoweringError, Pipeline, Stage, fuse, lower,
                              partition_by, pool_shutdown, reduce_by_key,
                              stable_hash, window)
from repro_torch.core.shm import SEG_PREFIX
from repro_torch.core.skeleton import FusedNode

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _segments():
    return set(glob.glob(f"/dev/shm/{SEG_PREFIX}{os.getpid()}_*"))


@pytest.fixture(autouse=True)
def no_leaked_segments():
    before = _segments()
    yield
    assert _segments() - before == set(), "leaked SharedMemory segments"


@pytest.fixture(autouse=True, scope="module")
def retire_pool():
    yield
    pool_shutdown()


def ref_rbk(xs, by, fold, seed=None):
    d = {}
    for x in xs:
        k = by(x)
        d[k] = fold(d[k], x) if k in d else (x if seed is None else fold(seed, x))
    return d


def _ref(build, xs):
    """The reference's threads output for the same skeleton."""
    return jcore.lower(build(jcore), "threads")(xs)


def _rbk5(c):
    return c.reduce_by_key(N.mod5, "sum", nleft=2, nright=3, nkeys=5)


RBK_T = lower(_rbk5(tcore), "threads")
RBK_P = lower(_rbk5(tcore), "procs")
RBK_J = jcore.lower(_rbk5(jcore), "threads")


@given(st.lists(st.integers(0, 1000), max_size=40))
@settings(max_examples=8, deadline=None)
def test_reduce_by_key_parity_threads(xs):
    want = ref_rbk(xs, N.mod5, lambda a, b: a + b)
    assert dict(RBK_T(xs)) == dict(RBK_J(xs)) == want


# Few examples: every example spawns 2 left + 3 right + the scatter.
@given(st.lists(st.integers(0, 1000), max_size=16))
@settings(max_examples=3, deadline=None)
def test_reduce_by_key_parity_procs(xs):
    assert dict(RBK_P(xs)) == dict(RBK_J(xs))


def test_parity_empty_stream():
    assert RBK_T([]) == RBK_P([]) == RBK_J([]) == []


@pytest.mark.parametrize("fold,ref", [("min", min), ("max", max),
                                      ("count", None)])
def test_named_folds_match_reference(fold, ref):
    xs = list(range(7, 43))
    build = lambda c: c.reduce_by_key(N.mod5, fold, nkeys=5)  # noqa: E731
    got = dict(lower(build(tcore), "threads")(xs))
    assert got == dict(_ref(build, xs))
    if ref is not None:
        assert got == ref_rbk(xs, N.mod5, ref)
    else:
        assert got == {k: sum(1 for x in xs if x % 5 == k) for k in range(5)}


def test_batched_zero_copy_procs_matches_reference():
    xs = list(range(64))
    assert dict(lower(_rbk5(tcore), "procs", batch=8, zero_copy=True)(xs)) \
        == dict(RBK_J(xs))


# -- EOS fan-in termination + key-partition integrity (nleft != nright) ------
def _owners(out):
    owners = {}
    for j, v in out:
        owners.setdefault(N.mod3(v), set()).add(j)
    return owners


@pytest.mark.parametrize("backend,n", [("threads", 200), ("procs", 60)])
def test_eos_fanin_nleft_ne_nright(backend, n):
    """A 3×2 matrix terminates by per-edge EOS counting, loses and
    duplicates nothing, and every key is serviced by one right vertex —
    across processes too, where builtin hash salting would split it."""
    build = lambda c: c.AllToAll(N.double, [N.TagPartition(0),  # noqa: E731
                                            N.TagPartition(1)],
                                 by=N.mod3, nleft=3, nright=2)
    out = lower(build(tcore), backend)(range(n))
    assert sorted(out) == sorted(_ref(build, range(n)))
    assert all(len(s) == 1 for s in _owners(out).values())


def test_matrix_topology_is_nxm():
    skel = AllToAll(N.double, N.double, by=N.mod3, nleft=3, nright=4)
    g = lower(skel, "threads").to_graph(list(range(8)))
    lefts = [v for v in g.vertices if "-L" in v.name]
    rights = [v for v in g.vertices if "-R" in v.name]
    assert len(lefts) == 3 and len(rights) == 4
    assert all(len(lv.outs) == 4 for lv in lefts)
    assert all(len(rv.ins) == 3 for rv in rights)


@pytest.mark.parametrize("backend,n", [("threads", 80), ("procs", 24)])
def test_ordered_a2a_preserves_stream_order(backend, n):
    build = lambda c: c.AllToAll(N.double, N.double, by=N.mod3,  # noqa: E731
                                 nleft=2, nright=3, ordered=True)
    xs = list(range(n))
    assert lower(build(tcore), backend)(xs) == _ref(build, xs) \
        == [x * 4 for x in xs]


@pytest.mark.parametrize("backend", ["threads", "procs"])
def test_a2a_composes_in_pipeline(backend):
    build = lambda c: c.Pipeline(c.Stage(N.double),  # noqa: E731
                                 c.reduce_by_key(N.mod3, "sum", nright=2),
                                 c.Stage(N.second))
    assert sorted(lower(build(tcore), backend)(range(30))) \
        == sorted(_ref(build, range(30)))


def test_a2a_into_farm():
    build = lambda c: c.Pipeline(  # noqa: E731
        c.AllToAll(N.double, N.double, by=N.mod3, nleft=2, nright=2),
        c.Farm(N.f, 3))
    assert sorted(lower(build(tcore), "threads")(range(40))) \
        == sorted(_ref(build, range(40))) \
        == sorted(N.f(x * 4) for x in range(40))


# -- fuse must not cross an AllToAll boundary --------------------------------
def test_fuse_does_not_cross_a2a():
    a2a = reduce_by_key(N.mod3, "sum", nright=2)
    skel = Pipeline(Stage(N.f, grain=1), Stage(N.g, grain=1), a2a,
                    Stage(N.second, grain=1), Stage(N.double, grain=1))
    fused = fuse(skel, force=True)
    assert [type(s) for s in fused.stages] == [Stage, AllToAll, Stage]
    assert fused.stages[1] is a2a
    assert isinstance(fused.stages[0].node, FusedNode)
    assert isinstance(fused.stages[2].node, FusedNode)
    want = ref_rbk([N.g(N.f(x)) for x in range(20)], N.mod3,
                   lambda a, b: a + b)
    assert sorted(lower(fused, "threads", fuse=False)(range(20))) \
        == sorted(v * 2 for v in want.values())


def test_fused_window_stage_flushes_svc_eos():
    skel = Pipeline(window(4, "sum"), Stage(N.double, grain=1))
    fused = fuse(skel, force=True)
    assert not isinstance(fused, Pipeline)
    assert lower(fused, "threads")(range(10)) == [12, 44, 34]
    assert lower(skel, "threads", fuse=False)(range(10)) == [12, 44, 34]


# -- stream_ops ----------------------------------------------------------------
@pytest.mark.parametrize("backend", ["threads", "procs"])
def test_window_tumbling_and_eos_flush(backend):
    build = lambda c: c.window(4, "sum")  # noqa: E731
    assert lower(build(tcore), backend)(range(10)) \
        == _ref(build, range(10)) == [6, 22, 17]


def test_window_folds_match_reference():
    for build, xs in ((lambda c: c.window(3, "max"), [5, 1, 9, 2, 8]),
                      (lambda c: c.window(5, "sum"), []),
                      (lambda c: c.window(2, N.keep_larger, init=100),
                       [3, 7, 50, 9])):
        assert lower(build(tcore), "threads")(xs) == _ref(build, xs)


def test_partition_by_pure_shuffle_and_fresh_workers():
    build = lambda c: c.partition_by(N.mod3, 3)  # noqa: E731
    assert sorted(lower(build(tcore), "threads")(range(50))) \
        == sorted(_ref(build, range(50))) == list(range(50))
    skel = partition_by(N.mod3, 2, worker=T.Dedup)
    assert sorted(lower(skel, "threads")([1, 2, 1, 3, 2, 4, 1])) \
        == [1, 2, 3, 4]
    assert len({id(n) for n in skel.right_nodes}) == 2


def test_custom_callable_folds_match_reference():
    xs = [3, 10, 5, 9, 14, 2]
    for build in (lambda c: c.reduce_by_key(N.mod3, N.keep_larger),
                  lambda c: c.reduce_by_key(N.mod3, N.keep_larger,
                                            init=1000)):
        assert dict(lower(build(tcore), "threads")(xs)) \
            == dict(_ref(build, xs))


# -- KeyAffinity scheduling policy -------------------------------------------
@pytest.mark.parametrize("backend,n", [("threads", 60), ("procs", 18)])
def test_keyaffinity_farm(backend, n):
    farm = Farm([N.TagPartition(0), N.TagPartition(1), N.TagPartition(2)],
                scheduling=KeyAffinity(N.mod3))
    out = lower(farm, backend)(range(n))
    assert sorted(x for _, x in out) == list(range(n))
    assert all(len(s) == 1 for s in _owners(out).values())


def test_keyaffinity_routes_as_the_reference():
    outs = [[None] * 5, [None] * 5]
    pols = [tcore.KeyAffinity(N.mod3), jcore.KeyAffinity(N.mod3)]
    for pol, o in zip(pols, outs):
        pol.bind(o, None)
    keys = list(range(-20, 20)) + ["a", "tenant-b", (1, "x")]
    assert [pols[0].route(k) for k in keys[:40]] \
        == [pols[1].route(k) for k in keys[:40]]
    plain = [tcore.KeyAffinity(), jcore.KeyAffinity()]
    for pol, o in zip(plain, outs):
        pol.bind(o, None)
    assert [plain[0].route(k) for k in keys] == [plain[1].route(k) for k in keys]


def test_keyaffinity_stage_route():
    from repro_torch.core.graph import StageVertex
    v = StageVertex(FnNode(N.double), route=KeyAffinity(N.mod3))
    assert v._sched is not None
    with pytest.raises(ValueError, match="token-holding"):
        StageVertex(FnNode(N.double), route="worksteal")


# -- stable_hash ---------------------------------------------------------------
_ATOMS = [0, -1, 7, 2 ** 80, -(2 ** 70), True, False, None, 0.0, -0.0, 3.0,
          2.5, -1e300, 1e-300, float("inf"), float("-inf"), float("nan"), "",
          "tenant-a", "\u00fc\u4e2d", b"", b"k\x00\xff"]


def _atom(kind, i, n, x):
    return (_ATOMS[i], n, x, str(n), str(n).encode(), float(n))[kind]


# Within the in-repo hypothesis shim's strategies: the test builds scalars,
# tuples, nested tuples and frozensets of every accepted type from them.
@given(st.lists(st.tuples(st.integers(0, 5), st.integers(0, len(_ATOMS) - 1),
                          st.integers(-2 ** 40, 2 ** 40),
                          st.floats(-1e6, 1e6)), min_size=1, max_size=8),
       st.integers(0, 8))
@settings(max_examples=300, deadline=None)
def test_stable_hash_equals_the_reference_digest(spec, cut):
    atoms = [_atom(*e) for e in spec]
    keys = atoms + [tuple(atoms), frozenset(atoms),
                    (tuple(atoms[:cut]), frozenset(atoms[cut:])),
                    ((atoms[0],), (tuple(atoms),))]
    for key in keys:
        assert stable_hash(key) == jcore.stable_hash(key), key


def test_stable_hash_agrees_with_dict_equality_for_numbers():
    for a, b in ((3.0, 3), (-0.0, 0), (0.0, 0), (True, 1), (False, 0)):
        assert stable_hash(a) == stable_hash(b) == jcore.stable_hash(a)
    assert stable_hash(frozenset({"a", "b", "c"})) == \
        stable_hash(frozenset({"c", "a", "b"}))
    build = lambda c: c.reduce_by_key(N.mod3, "sum", nright=3)  # noqa: E731
    out = dict(lower(build(tcore), "threads")([3, 3.0, 4, 4.0]))
    assert out == dict(_ref(build, [3, 3.0, 4, 4.0])) == {0: 6.0, 1: 8.0}


@pytest.mark.parametrize("key", [torch.tensor(3), torch.arange(2),
                                 np.int64(3), np.int32(3), np.float32(2.5),
                                 np.bool_(True), {"a": 1}, object()],
                         ids=lambda k: type(k).__name__)
def test_stable_hash_refuses_what_the_reference_refuses(key):
    with pytest.raises(TypeError, match="process-stable") as port:
        stable_hash(key)
    with pytest.raises(TypeError, match="process-stable") as ref:
        jcore.stable_hash(key)
    assert str(port.value) == str(ref.value)


def test_stable_hash_routes_tensors_by_their_values():
    """The refused types' values route as the reference's.  np.float64 is
    a float subclass, accepted by both with the same digest; a non-integral
    one hashes by its repr, which numpy 2 spells ``np.float64(2.5)``, so it
    routes apart from the equal float 2.5 in both packages."""
    t = torch.tensor([[3, 7], [11, 2]], dtype=torch.int32)
    vals = [v for row in t.tolist() for v in row]
    assert [stable_hash(v) for v in vals] == [jcore.stable_hash(v) for v in vals]
    for v in (np.float64(2.5), np.float64(3.0), np.float64(-0.0)):
        assert stable_hash(v) == jcore.stable_hash(v)
    assert stable_hash(np.float64(3.0)) == stable_hash(3)


def test_stable_hash_is_stable_across_interpreters():
    code = ("import sys; sys.path.insert(0, 'src')\n"
            "from repro_torch.core import stable_hash\n"
            "print(stable_hash('tenant-a'), stable_hash(('a', frozenset("
            "{'x', 'y'}))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    outs = {subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env={**env, "PYTHONHASHSEED": str(seed)}, timeout=120,
    ).stdout for seed in (1, 2, 3)}
    assert len(outs) == 1 and outs != {""}, outs
    assert outs == {f"{jcore.stable_hash('tenant-a')} "
                    f"{jcore.stable_hash(('a', frozenset({'x', 'y'})))}\n"}


# -- error contracts -----------------------------------------------------------
def test_ordered_a2a_rejects_multi_emit():
    skel = AllToAll(T.emit_twice, N.double, by=N.mod3, nleft=2, nright=2,
                    ordered=True)
    with pytest.raises(RuntimeError, match="EmitMany"):
        lower(skel, "threads")(range(8))
    out = lower(AllToAll(T.emit_twice, N.double, by=N.mod3, nright=2),
                "threads")(range(8))
    assert sorted(out) == sorted([x * 2 for x in range(8)] * 2)


def test_a2a_ir_errors_match_reference():
    for c in (tcore, jcore):
        with pytest.raises(ValueError, match="token-holding"):
            c.AllToAll(N.double, N.double, nleft=2, nright=2,
                       scheduling="worksteal")
        with pytest.raises(LoweringError if c is tcore else jcore.LoweringError,
                           match="upstream"):
            c.lower(c.AllToAll(N.double, N.double, by=N.mod3, ordered=True),
                    "threads").to_graph(None)
        with pytest.raises(AssertionError, match="unordered|undefined"):
            c.AllToAll(N.double, N.double, by=N.mod3, ordered=True,
                       reduce=object())


def test_fold_spec_errors_match_reference():
    for c in (tcore, jcore):
        with pytest.raises(ValueError, match="unknown fold"):
            c.reduce_by_key(N.mod3, "median")
        for call in (lambda: c.reduce_by_key(N.mod3, "sum", init=5),
                     lambda: c.window(3, "count", init=2),
                     lambda: c.reduce_by_key(N.mod3, "count", init=0)):
            with pytest.raises(ValueError, match="conflicts with the named"):
                call()
        for call in (lambda: c.reduce_by_key(N.mod3, c.FOLDS["max"], init=0),
                     lambda: c.window(2, c.FOLDS["min"], init=1)):
            with pytest.raises(ValueError, match="conflicts with the Fold"):
                call()


def test_reduce_spec_matches_reference():
    t, j = _rbk5(tcore), _rbk5(jcore)
    assert (t.reduce.fold.name, t.reduce.fold.kind, t.reduce.nkeys) \
        == (j.reduce.fold.name, j.reduce.fold.kind, j.reduce.nkeys)
    assert sorted(tcore.FOLDS) == sorted(jcore.FOLDS)
    assert reduce_by_key(N.mod3, N.keep_larger).reduce is None


def test_mesh_shuffle_over_cpu_ranks_needs_gloo():
    """The keyed program runs on one device (tests/test_torch_mesh.py) or
    over rank processes (tests/test_torch_mesh_ranks.py); CPU ranks need
    an explicit ``transport="gloo"``, and with it the program spans two
    workers."""
    with pytest.raises(LoweringError, match='transport="gloo"'):
        lower(_rbk5(tcore), "mesh", device="cpu", devices=2)
    prog = lower(_rbk5(tcore), "mesh", device="cpu", devices=2,
                 transport="gloo")
    assert prog.n_worker == 2 and prog.rank_devices == ["cpu", "cpu"]


# -- keyed aggregation of score tensors (chip_smoke.py's phase, small) --------
def _score_chunks(seed, n_chunks, width):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 2000, n_chunks * width)
    scores = rng.integers(0, 3000, n_chunks * width)
    return [torch.from_numpy(np.stack([lens[i:i + width] // 32,
                                       scores[i:i + width]]).astype(np.int32))
            for i in range(0, n_chunks * width, width)]


@pytest.mark.parametrize("fold", ["max", "count"])
def test_keyed_aggregation_of_score_tensors(fold):
    """(2, n) int32 chunks (length bucket, score) exploded into rows by
    the left nodes and reduced per bucket: threads and procs (2 left, 2
    right; the caller offloads each chunk over the tensor edge) equal
    scatter_reduce / bincount exactly, and the reference's threads fold
    of the same rows."""
    chunks = _score_chunks(5, 6, 256)
    flat = torch.cat(chunks, dim=1)
    buckets, scores = flat[0].long(), flat[1]
    nb = int(buckets.max()) + 1
    counts = torch.bincount(buckets, minlength=nb)
    if fold == "max":
        plain = torch.full((nb,), -1, dtype=torch.int32).scatter_reduce(
            0, buckets, scores, "amax", include_self=False)
    else:
        plain = counts
    want = {b: int(plain[b]) for b in range(nb) if counts[b] > 0}

    def value(v):
        return v[1] if fold == "max" else v

    skel = reduce_by_key(N.row_key, fold, nleft=2, nright=2,
                         left=T.explode_scores)
    acc = tcore.ProcAccelerator(skel)     # as chip_smoke.py drives it
    for chunk in chunks:
        acc.offload(chunk)
    for backend, out in (("threads", lower(skel, "threads")(chunks)),
                         ("procs", acc.wait(60))):
        assert {k: value(v) for k, v in out} == want, backend
    rows = [tuple(r) for c in chunks for r in c.t().tolist()]
    jskel = jcore.reduce_by_key(N.row_key, fold, nleft=2, nright=2)
    assert {k: value(v) for k, v in jcore.lower(jskel, "threads")(rows)} \
        == want
