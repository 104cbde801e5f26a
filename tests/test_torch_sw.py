"""Smith-Waterman in the PyTorch port against the JAX package.

The same numpy inputs go through ``repro.kernels`` (the Pallas kernel in
interpret mode, as the reference's own tests run it) and through
``repro_torch.kernels`` on the CPU, where the wrapper runs the kernel's
plain PyTorch version.  Tolerance: exact ``==`` — the scores are
integer-valued f32.  The card-only cases are in ``test_torch_gpu.py``.
"""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import ops, ref
from repro_torch.kernels import smith_waterman as sw
from repro_torch.kernels.smith_waterman import MAX_QP, sw_batch, sw_plain

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
    assert ops.encode_seq(seq).tolist() == np.asarray(jops.encode_seq(seq)).tolist()


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
    seq = ops.encode_seq("HEAGAWGHEE")
    diag = float(sum(ops.BLOSUM50[c, c] for c in seq.tolist()))
    got = float(ops.smith_waterman(seq, seq, tile=64, device=CPU))
    jseq = jops.encode_seq("HEAGAWGHEE")
    assert got == diag == float(jops.smith_waterman(jseq, jseq, tile=64))


def test_sw_empty_overlap_zero():
    a, b = ops.encode_seq("AAAA"), ops.encode_seq("WWWW")  # A-W = -3
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
    q = ops.encode_seq("HEAGAWGHEE")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.smith_waterman(q, q)
    with pytest.raises(RuntimeError):
        convert.matrix_from_numpy(np.asarray(jops.BLOSUM50))


def test_launch_count_loses_no_update_across_threads():
    """Farm workers count launches from several threads at once."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sw.reset_launch_count()
        threads = [threading.Thread(target=lambda: [sw._count_launch()
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert sw.launch_count() == 16 * 2000
    finally:
        sys.setswitchinterval(switch)
        sw.reset_launch_count()
