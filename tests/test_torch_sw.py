"""Smith-Waterman in the PyTorch port against the JAX package.

The same numpy inputs go through ``repro.kernels`` (the Pallas kernel in
interpret mode, as the reference's own tests run it) and through
``repro_torch.kernels`` on the CPU, where the wrapper runs the kernel's
plain PyTorch version.  Tolerance: exact ``==`` — the scores are
integer-valued f32.  The card-only cases are in ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import convert
from repro_torch.core import FnNode, TaskFarm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import smith_waterman as sw
from repro_torch.kernels.smith_waterman import (MAX_QP, NEG, pack_subjects,
                                                sw_batch, sw_plain)

CPU = "cpu"
GAPS = [(10.0, 2.0), (5.0, 2.0)]  # the paper's two regimes


def _codes(rng, n):
    return rng.integers(0, 20, n).astype(np.int32)


def _port_profile(q):
    """The reference's profile of ``q``, carried across by convert."""
    prof, q_len = jops.build_profile(jnp.asarray(q))
    return convert.profile_from_numpy(np.asarray(prof), q_len, device=CPU)


def _score_fn(m):
    idx = jops.AA_ALPHABET.index
    return lambda a, b: float(m[idx(a), idx(b)])


def test_blosum50_matches_reference():
    m = ops.BLOSUM50
    assert m.shape == (24, 24) and m.dtype == torch.float32
    assert torch.equal(m, m.T)
    assert np.array_equal(m.numpy(), np.asarray(jops.BLOSUM50))
    carried = convert.matrix_from_numpy(np.asarray(jops.BLOSUM50), device=CPU)
    assert torch.equal(carried, m)
    assert ops.AA_ALPHABET == jops.AA_ALPHABET


def test_encode_seq_matches_reference():
    seq = "HEAGAWGHEEjoz*"
    assert ops.encode_seq(seq, device=CPU).tolist() == np.asarray(jops.encode_seq(seq)).tolist()


@pytest.mark.parametrize("qlen", [1, 24, 128, 129, 300])
def test_build_profile_matches_reference(qlen):
    q = _codes(np.random.default_rng(qlen), qlen)
    prof, q_len = ops.build_profile(torch.from_numpy(q))
    carried, c_len = _port_profile(q)
    assert q_len == c_len == qlen
    assert prof.shape[1] % 128 == 0 and prof.dtype == torch.float32
    assert torch.equal(prof, carried)
    assert torch.all(prof[:, qlen:] == -1e4)


def test_sw_known_alignment():
    """Identical sequences: score == sum of diagonal substitution scores."""
    seq = ops.encode_seq("HEAGAWGHEE", device=CPU)
    diag = float(sum(ops.BLOSUM50[c, c] for c in seq.tolist()))
    got = float(ops.smith_waterman(seq, seq, tile=64, device=CPU))
    jseq = jops.encode_seq("HEAGAWGHEE")
    assert got == diag == float(jops.smith_waterman(jseq, jseq, tile=64))


def test_sw_empty_overlap_zero():
    a, b = ops.encode_seq("AAAA", device=CPU), ops.encode_seq("WWWW", device=CPU)  # A-W = -3
    assert float(ops.smith_waterman(a, b, tile=64, device=CPU)) == 0.0
    assert float(jops.smith_waterman(jops.encode_seq("AAAA"),
                                     jops.encode_seq("WWWW"), tile=64)) == 0.0


@pytest.mark.parametrize("gaps", GAPS)
@pytest.mark.parametrize("qlen,dlen", [(7, 13), (30, 64), (64, 200), (129, 70)])
def test_sw_matches_reference_and_sequential_ref(gaps, qlen, dlen):
    """port smith_waterman == JAX ops.smith_waterman == port sw_ref."""
    go, ge = gaps
    rng = np.random.default_rng(qlen * dlen)
    q, d = _codes(rng, qlen), _codes(rng, dlen)
    got = float(ops.smith_waterman(torch.from_numpy(q), torch.from_numpy(d),
                                   gap_open=go, gap_extend=ge, tile=64,
                                   device=CPU))
    want_jax = float(jops.smith_waterman(jnp.asarray(q), jnp.asarray(d),
                                         gap_open=go, gap_extend=ge, tile=64))
    prof, _ = _port_profile(q)
    want_ref = float(ref.sw_ref(prof, torch.from_numpy(d), go, ge))
    assert got == want_jax == want_ref


@given(st.integers(1, 25), st.integers(1, 40), st.integers(0, 10_000))
@settings(max_examples=25, deadline=None)
def test_sw_property_triple_check(qlen, dlen, seed):
    """port kernel path == port sw_numpy == reference sw_numpy."""
    rng = np.random.default_rng(seed)
    q, d = _codes(rng, qlen), _codes(rng, dlen)
    got = float(ops.smith_waterman(torch.from_numpy(q), torch.from_numpy(d),
                                   tile=64, device=CPU))
    qs = "".join(ops.AA_ALPHABET[i] for i in q)
    ds = "".join(ops.AA_ALPHABET[i] for i in d)
    fn = _score_fn(np.asarray(jops.BLOSUM50))
    want = ref.sw_numpy(qs, ds, fn, 10.0, 2.0)
    assert got == want == jref.sw_numpy(qs, ds, fn, 10.0, 2.0)


def test_sw_tile_invariance():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_codes(rng, 40))
    d = torch.from_numpy(_codes(rng, 300))
    scores = {t: float(ops.smith_waterman(q, d, tile=t, device=CPU))
              for t in (64, 128, 256)}
    assert len(set(scores.values())) == 1, scores


@pytest.mark.parametrize("gaps", GAPS)
def test_sw_batch_with_lengths_matches_single_pairs(gaps):
    """One batched call, ragged lengths and chars >= A inside, equals the
    reference's per-pair scores."""
    go, ge = gaps
    rng = np.random.default_rng(17)
    q = _codes(rng, 50)
    prof, q_len = _port_profile(q)
    subjects = [_codes(rng, n) for n in (1, 9, 64, 130)]
    subjects[2][::5] = 24 + rng.integers(0, 5)        # padding codes >= A
    batch = torch.full((4, 160), 3, dtype=torch.int32)  # junk past the lengths
    for i, s in enumerate(subjects):
        batch[i, :len(s)] = torch.from_numpy(s)
    lengths = torch.tensor([len(s) for s in subjects], dtype=torch.int32)
    got = sw_batch(prof, batch, lengths, gap_open=go, gap_extend=ge,
                   q_len=q_len)
    want = [float(jops.smith_waterman(jnp.asarray(q), jnp.asarray(s),
                                      gap_open=go, gap_extend=ge, tile=64))
            for s in subjects]
    assert got.tolist() == want
    single = [float(sw_plain(prof, torch.from_numpy(s), go, ge, q_len))
              for s in subjects]
    assert single == want


def _chunked_search(query, db, chunk, gap_open, gap_extend):
    """The database search as the main path drives it: sort by length,
    longest first; one ``sw_batch`` call per chunk through the ordered
    farm; scores scattered back to database order."""
    prof, q_len = ops.build_profile(torch.from_numpy(query))
    A = prof.shape[0]
    order = sorted(range(len(db)), key=lambda i: -len(db[i]))
    chunks = [pack_subjects([db[i] for i in order[c:c + chunk]], A, CPU)
              for c in range(0, len(db), chunk)]
    farm = TaskFarm(2, preserve_order=True)
    farm.add_stream(chunks)
    farm.add_worker(FnNode(lambda ch: sw_batch(
        prof, *ch, gap_open=gap_open, gap_extend=gap_extend, q_len=q_len)))
    flat = torch.cat(farm.run_and_wait())
    scores = torch.empty(len(db))
    scores[torch.tensor(order)] = flat
    return scores.tolist(), len(chunks)


def test_chunked_search_matches_one_subject_and_reference():
    """``pack_subjects`` pads with A and keeps the true lengths, an empty
    subject included.  Length-sorted chunks of 8 through the farm, in
    database order, equal the one-subject entry point on every subject and
    the JAX package on a sample, bit for bit, in both gap regimes.  The
    database has an all-padding subject and one with interior codes >= A."""
    subjects = [np.array([3, 1, 4], np.int32), np.zeros(0, np.int32),
                torch.tensor([15, 9], dtype=torch.int32), np.array([2], np.int64)]
    subj, lengths = pack_subjects(subjects, 24, CPU)
    assert subj.dtype == lengths.dtype == torch.int32
    assert lengths.tolist() == [3, 0, 2, 1]
    assert subj.tolist() == [[3, 1, 4], [24, 24, 24], [15, 9, 24], [2, 24, 24]]
    empty, no_lengths = pack_subjects([], 24, CPU)
    assert empty.shape == (0, 0) and no_lengths.shape == (0,)

    rng = np.random.default_rng(40)
    query = _codes(rng, 37)
    db = [_codes(rng, int(n)) for n in rng.integers(1, 701, 40)]
    db[5] = np.full(30, 24, np.int32)                  # all padding
    db[9][::4] = 24 + rng.integers(0, 6, len(db[9][::4]))  # codes >= A inside
    sample = [5, 9] + list(rng.choice(40, 10, replace=False))
    q, jq = torch.from_numpy(query), jnp.asarray(query)
    for go, ge in GAPS:
        got, n_chunks = _chunked_search(query, db, 8, go, ge)
        assert n_chunks == 5
        one = [float(ops.smith_waterman(q, torch.from_numpy(d), gap_open=go,
                                        gap_extend=ge, device=CPU))
               for d in db]
        assert got == one
        assert got[5] == 0.0 and max(got) > 0
        want = [float(jops.smith_waterman(jq, jnp.asarray(db[i]), gap_open=go,
                                          gap_extend=ge)) for i in sample]
        assert [got[i] for i in sample] == want


@pytest.mark.parametrize("qlen", [0, MAX_QP + 1])
def test_query_block_outside_limits_raises(qlen):
    q = torch.zeros(qlen, dtype=torch.int32)
    with pytest.raises(ValueError, match="8192"):
        ops.smith_waterman(q, torch.zeros(10, dtype=torch.int32), device=CPU)


def test_wrapper_rejects_wrong_types():
    prof, q_len = ops.build_profile(torch.zeros(5, dtype=torch.int32))
    with pytest.raises(TypeError):
        sw_batch(prof, torch.zeros((1, 8), dtype=torch.int64), gap_open=10.0,
                 gap_extend=2.0, q_len=q_len)
    with pytest.raises(ValueError):
        sw_batch(prof[:, :100], torch.zeros((1, 8), dtype=torch.int32),
                 gap_open=10.0, gap_extend=2.0, q_len=q_len)


def test_default_device_is_the_card_no_cpu_path(monkeypatch):
    """device=None means CUDA; without a card it raises, never runs on CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = ops.encode_seq("HEAGAWGHEE", device=CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.smith_waterman(q, q)
    with pytest.raises(RuntimeError):
        convert.matrix_from_numpy(np.asarray(jops.BLOSUM50))


def test_encode_seq_defaults_to_the_card(monkeypatch):
    """encode_seq resolves device=None to CUDA, as every entry point does:
    without a card it raises instead of returning a CPU tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.encode_seq("HEAGAWGHEE")
    assert ops.encode_seq("HEAGAWGHEE", device=CPU).device.type == "cpu"


@pytest.mark.parametrize("Qp,B,path", [
    (128, 1, "warp"), (1024, 1, "warp"), (1024, 100_000, "warp"),
    (1152, 1, "block"), (1152, sw.STRIP_MIN_B - 1, "block"),
    (1152, sw.STRIP_MIN_B, "strip"), (1152, 4096, "strip"),
    (8192, sw.STRIP_MIN_B - 1, "block"), (8192, sw.STRIP_MIN_B, "strip"),
])
def test_sw_path_rule(Qp, B, path):
    """Up to 1024 rows the warp kernel at every B; above, the strip kernel
    from STRIP_MIN_B subjects a launch (one more than the H100's 132 SMs),
    the block kernel below."""
    assert sw.STRIP_MIN_B == 133
    assert sw._sw_path(Qp, B) == path


def _sw_strips(profile, subj, go, ge, q_len, strip):
    """``sw_plain`` cut into strips of ``strip`` query rows, top first, as
    the strip kernel runs it: each strip scores every subject char, taking
    from the strip above, per processed char, H of its last row (the left
    neighbour of the strip's first row, one processed char later) and the
    max of ``h_hat + i*ge`` over every row above (the seed of the
    exclusive prefix-max)."""
    A, Qp = profile.shape
    B, D = subj.shape
    f32 = torch.float32
    go_t, ge_t = torch.tensor(go, dtype=f32), torch.tensor(ge, dtype=f32)
    zero = torch.zeros((), dtype=f32)
    idx = torch.arange(Qp, dtype=f32)
    idx_ge, idx_m1_ge = idx * ge_t, (idx - 1.0) * ge_t
    carry_h = torch.zeros((B, D), dtype=f32)
    carry_p = torch.full((B, D), NEG, dtype=f32)
    best = torch.zeros((B,), dtype=f32)
    for r0 in range(0, Qp, strip):
        rows = slice(r0, min(r0 + strip, Qp))   # a ragged last strip
        qmask = idx[rows] < q_len
        h = torch.zeros((B, rows.stop - r0), dtype=f32)
        e = torch.full((B, rows.stop - r0), NEG, dtype=f32)
        hl = torch.zeros((B,), dtype=f32)   # H above, last processed char
        out_h, out_p = carry_h.clone(), carry_p.clone()
        for j in range(D):
            c = subj[:, j].long()
            valid = c < A
            s = profile[c.clamp(0, A - 1)][:, rows]
            e_new = torch.maximum(h - go_t, e - ge_t)
            h_shift = torch.cat([hl[:, None], h[:, :-1]], dim=1)
            h_hat = torch.maximum(torch.maximum(h_shift + s, e_new), zero)
            h_hat = torch.where(qmask, h_hat, zero)
            x = h_hat + idx_ge[rows]
            p = torch.cummax(torch.cat([carry_p[:, j:j + 1], x[:, :-1]], dim=1),
                             dim=1).values
            h_new = torch.where(qmask, torch.maximum(
                h_hat, p - go_t - idx_m1_ge[rows]), zero)
            v = valid[:, None]
            h = torch.where(v, h_new, h)
            e = torch.where(v, e_new, e)
            best = torch.where(valid, torch.maximum(best, h_new.amax(dim=1)),
                               best)
            hl = torch.where(valid, carry_h[:, j], hl)
            out_h[:, j] = h_new[:, -1]
            out_p[:, j] = torch.maximum(p[:, -1], x[:, -1])
        carry_h, carry_p = out_h, out_p
    return best


def _strip_subjects(rng, query, strip, n_random, A=24):
    """Random subjects with interior padding codes and negative codes, and
    query segments across each strip boundary: one on the diagonal, one
    with a vertical gap across the boundary, one with padding inside."""
    subjects = [_codes(rng, int(n)) for n in rng.integers(1, 120, n_random)]
    subjects[0][::3] = A + 4
    subjects[1][1::5] = -2
    for t in range(strip, len(query), strip):
        seg = query[max(t - 40, 0):t + 40]
        gap = np.concatenate([query[max(t - 40, 0):t - 2], query[t + 3:t + 40]])
        pad = np.insert(seg, [5, len(seg) // 2, len(seg) // 2], A + 2)
        subjects += [seg.copy(), gap, pad.astype(np.int32)]
    return subjects


@pytest.mark.parametrize("qlen,strip", [(129, 128), (300, 128), (1025, 256),
                                        (1800, 256), (3000, 256)])
def test_strip_carry_equals_sw_plain(qlen, strip):
    """The strip decomposition (the strip kernel's carry arithmetic) is
    bit for bit ``sw_plain``, in all three gap settings of the card tests."""
    rng = np.random.default_rng(qlen)
    query = _codes(rng, qlen)
    prof, q_len = ops.build_profile(torch.from_numpy(query))
    subj, _ = pack_subjects(_strip_subjects(rng, query, strip, 4), 24, CPU)
    for go, ge in GAPS + [(10.3, 2.1)]:
        want = sw_plain(prof, subj, go, ge, q_len)
        got = _sw_strips(prof, subj, go, ge, q_len, strip)
        assert torch.equal(got, want), (go, ge, got.tolist(), want.tolist())
    assert want.max() > 100   # the boundary segments align across strips
