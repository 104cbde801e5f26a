"""The port's out-of-core keyed aggregation (``repro_torch.core.oocore``)
against the reference's: ``SpillFold`` equal to the in-memory ``_KeyFold``
under forced spills, budgeted ``reduce_by_key`` / ``shard_reduce`` /
``rekey_reduce`` giving the reference's results on the port's threads
and procs backends, the ``MemoryBudget`` board surfacing spill and stall
counts across the process boundary (cumulative over runs), the
``BudgetBackpressure`` policy's stall sequence, ``ShardReader`` and the
map-side ``CombiningReader`` emitting what the reference's emit, and the
``KeyBatch`` wire format staying invisible to batch-oblivious nodes."""
import glob
import os

import pytest
from hypothesis import given, settings, strategies as st

import _procs_nodes as N
import _torch_procs_nodes as T
import repro.core as jcore
import repro_torch.core as tcore
from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import oocore as joocore
from repro_torch.core import (AllToAll, KeyBatch, MemoryBudget, Pipeline,
                              SpillFold, Stage, fuse, lower, pool_shutdown,
                              reduce_by_key, shard_reduce, shard_source)
from repro_torch.core.oocore import CombiningReader, ShardReader, rekey_reduce
from repro_torch.core.sched import SCHEDULERS, BudgetBackpressure
from repro_torch.core.shm import SEG_PREFIX
from repro_torch.core.skeleton import FusedNode
from repro_torch.core.stream_ops import _KeyFold


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


def run_source_skel(skel, backend, core=tcore, timeout=60):
    """Source-left skeletons (shard_reduce) carry their own stream."""
    g = core.lower(skel, backend).to_graph(None)
    g.run()
    return g.wait(timeout)


def _row_stats_ref(reader, n):
    want = {}
    for k, v in reader(0, n):
        c, t = want.get(k, (0, 0.0))
        want[k] = (c + 1, t + v)
    return want


def _flush(fold):
    out = []
    for chunk in (fold.svc_eos() or []):
        out.extend(chunk)
    return out


# budget=256 < the ~150 bytes/entry × 5 keys of hot state: spills constantly
def _brbk(c):
    return c.reduce_by_key(N.mod5, "sum", nleft=2, nright=3, nkeys=5,
                           budget=256)


BRBK_T = lower(_brbk(tcore), "threads")
BRBK_P = lower(_brbk(tcore), "procs")
BRBK_J = jcore.lower(_brbk(jcore), "threads")


# -- SpillFold == _KeyFold, and == the reference's SpillFold -----------------
@given(st.lists(st.integers(-60, 60), max_size=80))
@settings(max_examples=15, deadline=None)
def test_spillfold_matches_keyfold_and_reference_forced_spills(xs):
    kf = _KeyFold(abs, N.keep_larger)
    sf = SpillFold(abs, N.keep_larger, budget=MemoryBudget(300))
    jf = joocore.SpillFold(abs, N.keep_larger,
                           budget=joocore.MemoryBudget(300))
    for x in xs:
        kf.svc(x)
        sf.svc(x)
        jf.svc(x)
    assert len(sf._runs) == len(jf._runs)   # same spill decisions
    got = _flush(sf)
    assert got == _flush(jf)                # same sorted flush
    assert dict(got) == dict(kf.svc_eos() or [])
    assert sf._acc == {} and not sf._runs and sf._dir is None


def test_spillfold_spills_and_accounts_as_the_reference():
    boards = []
    for mod in (tcore, jcore):
        b = mod.MemoryBudget(500)
        sf = mod.SpillFold(abs, N.keep_larger, budget=b)
        for x in range(-300, 300):
            sf.svc(x)
        assert b.spills() > 0 and b.held_total() <= b.limit
        boards.append((b.spills(), b.spill_bytes(), b.held_total()))
        assert dict(_flush(sf)) == ref_rbk(range(-300, 300), abs,
                                           N.keep_larger)
        assert b.held_total() == 0
    assert boards[0] == boards[1]


def test_spillfold_seeded_fold_needs_combine():
    with pytest.raises(ValueError, match="combine"):
        SpillFold(N.row_key, N.row_stats, (0, 0.0), False,
                  budget=MemoryBudget(1000))
    with pytest.raises(ValueError, match="combine"):
        shard_reduce(N.RangeRows(100, 5), N.row_key, N.row_stats,
                     init=(0, 0.0), budget=1000)
    skel = reduce_by_key(N.mod5, "count", nright=2, budget=400)
    assert dict(lower(skel, "threads")(range(23))) == \
        {k: sum(1 for x in range(23) if x % 5 == k) for k in range(5)}


# -- budgeted reductions: same skeleton, reference result --------------------
@given(st.lists(st.integers(0, 1000), max_size=40))
@settings(max_examples=8, deadline=None)
def test_budgeted_rbk_parity_threads(xs):
    want = ref_rbk(xs, N.mod5, lambda a, b: a + b)
    assert dict(BRBK_T(xs)) == dict(BRBK_J(xs)) == want


@given(st.lists(st.integers(0, 1000), max_size=16))
@settings(max_examples=3, deadline=None)
def test_budgeted_rbk_parity_procs(xs):
    assert dict(BRBK_P(xs)) == dict(BRBK_J(xs))


def test_budgeted_flush_byte_identical_across_backends_and_packages():
    """nright=1: one partition holds every key, so the whole flush order
    shows — port threads, port procs and the reference's threads emit the
    identical sorted list, and report the same spill counts."""
    build = lambda c: c.reduce_by_key(abs, "sum", nright=1,  # noqa: E731
                                      budget=2000)
    xs = [x - 200 for x in range(400)]
    skel, jskel = build(tcore), build(jcore)
    t = lower(skel, "threads")(xs)
    spills = skel.stats.spills
    p = lower(build(tcore), "procs")(xs)
    j = jcore.lower(jskel, "threads")(xs)
    assert t == p == j == sorted(t, key=lambda kv: kv[0])
    assert spills == jskel.stats.spills > 0


def test_procs_budget_board_surfaces_stats_cumulatively():
    skel = reduce_by_key(abs, "sum", nright=2, budget=1500)
    prog = lower(skel, "procs")
    xs = [x - 300 for x in range(600)]
    want = ref_rbk(xs, abs, lambda a, b: a + b)
    assert dict(prog(xs)) == want
    first = skel.stats.spills
    assert first > 0 and skel.stats.spill_bytes > 0
    assert dict(prog(xs)) == want
    assert skel.stats.spills > first


def test_budget_backpressure_policy_matches_reference():
    """The stall sequence, hysteresis included, is the reference's."""
    assert SCHEDULERS["budget"] is BudgetBackpressure
    seqs = []
    for mod in (tcore, jcore):
        b = mod.MemoryBudget(1000, nparts=2)
        pol = mod.BudgetBackpressure(b, max_stall_s=0.01).fresh()
        pol.bind([None, None], None)
        seq = [pol.pick(), b.stalls()]
        b.charge(0, 1000)
        b.charge(1, 900)                 # 1900/2000 > ¾ high-water
        seq += [b.over_total(), pol.pick(), b.stalls(), pol.pick(),
                b.stalls()]
        b.charge(0, -1000)
        b.charge(1, -900)
        seq += [b.over_total(), pol.pick()]
        b.charge(0, 1000)
        b.charge(1, 900)
        seq += [pol.pick(), b.stalls()]
        seqs.append(seq)
    assert seqs[0] == seqs[1] == [0, 0, True, 1, 1, 0, 1, False, 1, 0, 2]


def test_memory_budget_adapts_as_the_reference():
    limits = []
    for mod in (tcore, jcore):
        b = mod.MemoryBudget(4096, nparts=2, adaptive=True)
        stats = mod.FarmStats()
        seq = []
        for spills, stalls in ((0, 0), (2, 0), (1, 3), (0, 0)):
            for _ in range(spills):
                b.spilled(0, 100)
            for _ in range(stalls):
                b.stalled()
            b.fold_into(stats)
            seq.append((b.limit, stats.spills, stats.backpressure_stalls))
        limits.append(seq)
    assert limits[0] == limits[1]


# -- columnar sharding and the map-side combiner ------------------------------
def _drain_source(node):
    out = []
    while True:
        b = node.svc(None)
        if b is None:
            return out
        out.extend(b)


def test_shard_source_and_reader_match_reference():
    reader = N.RangeRows(1000, 7)
    got = [_drain_source(s) for s in shard_source(reader, 3, batch_rows=64)]
    want = [_drain_source(s)
            for s in jcore.shard_source(reader, 3, batch_rows=64)]
    assert got == want
    assert sorted(r for g in got for r in g) == sorted(reader(0, 1000))
    s = ShardReader(N.RangeRows(100, 5), 0, 2, batch_rows=16)
    assert _drain_source(s) == _drain_source(s)   # cursor reset at EOS


def test_combining_reader_emits_what_the_reference_emits():
    """Under a tiny bound the combiner evicts partials early as KeyBatch
    messages: the port's emission sequence is the reference's, and
    re-combining it reproduces the exact fold."""
    reader = N.RangeRows(2000, 50)
    seqs = []
    for mod, oo in ((tcore, tcore.oocore), (jcore, joocore)):
        cr = oo.CombiningReader(oo.ShardReader(reader, 0, 1, batch_rows=128),
                                N.row_key, N.row_stats, (0, 0.0), False,
                                combine=N.merge_stats, limit_bytes=2000)
        cr.svc_init()
        seq = []
        while True:
            out = cr.svc(None)
            if out is None:
                break
            if out is mod.GO_ON:
                continue
            assert type(out) is mod.KeyBatch
            seq.append(list(out))
        seq.append(list(cr.svc_eos() or []))
        seqs.append(seq)
    assert seqs[0] == seqs[1] and len(seqs[0]) > 2
    acc = {}
    for k, v in (p for batch in seqs[0] for p in batch):
        acc[k] = N.merge_stats(acc[k], v) if k in acc else v
    assert acc == _row_stats_ref(reader, 2000)


# -- the whole composition: shard_reduce ---------------------------------------
@given(st.integers(2, 4), st.integers(1, 3))
@settings(max_examples=4, deadline=None)
def test_shard_reduce_threads_matches_reference(nleft, nright):
    reader = N.RangeRows(3000, 200)
    build = lambda c: c.shard_reduce(  # noqa: E731
        reader, N.row_key, N.row_stats, init=(0, 0.0), combine=N.merge_stats,
        nleft=nleft, nright=nright, budget=3000, batch_rows=256)
    skel, jskel = build(tcore), build(jcore)
    got = run_source_skel(skel, "threads")
    assert dict(got) == dict(run_source_skel(jskel, "threads", jcore)) \
        == _row_stats_ref(reader, 3000)
    assert skel.stats.spills > 0


def test_shard_reduce_procs_with_stats():
    reader = N.RangeRows(4000, 300)
    skel = shard_reduce(reader, N.row_key, N.row_stats, init=(0, 0.0),
                        combine=N.merge_stats, nleft=2, nright=2,
                        budget=3000, batch_rows=256)
    assert dict(run_source_skel(skel, "procs")) == \
        _row_stats_ref(reader, 4000)
    assert skel.stats.spills > 0 and skel.stats.spill_bytes > 0


# -- multi-stage shuffles: a2a ∘ a2a -------------------------------------------
@pytest.mark.parametrize("backend", ["threads", "procs"])
def test_rekey_reduce_matches_reference(backend):
    def build(c):
        first = c.reduce_by_key(abs, "sum", nright=2, budget=2000)
        return c.rekey_reduce(first, N.mod10_pair, N.add_val, init=0.0,
                              combine=N.add2, nright=2, budget=1500)

    xs = [x - 300 for x in range(600)]
    want = {}
    for k, v in ref_rbk(xs, abs, lambda a, b: a + b).items():
        want[k % 10] = want.get(k % 10, 0.0) + v
    assert dict(lower(build(tcore), backend)(xs)) \
        == dict(jcore.lower(build(jcore), "threads")(xs)) == want


def test_rekey_reduce_is_two_a2a_and_fuse_never_crosses():
    first = reduce_by_key(abs, "sum", nright=2, budget=2000)
    chain = rekey_reduce(first, N.mod10_pair, N.add_val, init=0.0,
                         combine=N.add2, nright=2)
    assert [type(s) for s in chain.stages] == [AllToAll, AllToAll]
    padded = Pipeline(Stage(N.f), Stage(N.g), chain.stages[0],
                      Stage(N.sq), Stage(N.double), chain.stages[1])
    fused = fuse(padded, force=True)
    assert [type(s) for s in fused.stages].count(AllToAll) == 2
    assert fused.stages[1] is chain.stages[0]
    assert fused.stages[3] is chain.stages[1]
    assert isinstance(fused.stages[0].node, FusedNode)
    assert isinstance(fused.stages[2].node, FusedNode)


# -- KeyBatch transport transparency ------------------------------------------
@pytest.mark.parametrize("backend", ["threads", "procs"])
def test_keybatch_unpacks_for_batch_oblivious_nodes(backend):
    skel = Pipeline(Stage(T.emit_pair_batch), Stage(N.second))
    jskel = jcore.Pipeline(jcore.Stage(N.emit_pair_batch),
                           jcore.Stage(N.second))
    assert sorted(lower(skel, backend)(range(20))) \
        == sorted(jcore.lower(jskel, "threads")(range(20))) \
        == sorted([0.5 * x for x in range(20)]
                  + [0.5 * x + 1 for x in range(20)])
    assert KeyBatch is tcore.KeyBatch
