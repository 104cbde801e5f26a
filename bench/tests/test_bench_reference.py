"""The plain references against the port's plain versions at small sizes
on the CPU, the frozen work counts against the numbers chip_smoke.py
printed, and the database generator against the release's statistics."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import gen
from bench.counts import work
from bench.reference import phi3
from bench.reference import sw as ref_sw
from bench.tests import tiny

PHI3 = json.loads((Path(__file__).resolve().parents[1] / "configs/phi3-mini-3.8b.json").read_text())


def test_sw_reference_equals_the_ports_plain_version():
    from repro_torch.kernels import ops, smith_waterman as sw
    rng = np.random.default_rng(3)
    queries = [torch.as_tensor(rng.integers(0, 20, n).astype(np.int32)) for n in (1, 9, 64, 150)]
    gaps = [(10.0, 2.0), (5.0, 2.0), (10.0, 2.0), (5.0, 2.0)]
    subjects = [rng.integers(0, 20, n).astype(np.int32) for n in rng.integers(1, 200, 24)]
    subj, lens = sw.pack_subjects(subjects, ops.BLOSUM50.shape[0], "cpu")
    got = ref_sw.sw_scores(queries, gaps, subj, lens)
    assert torch.equal(ref_sw.blosum50(), ops.BLOSUM50)
    for k, q in enumerate(queries):
        prof, q_len = ops.build_profile(q)
        want = sw.sw_batch(prof, subj, lens, gap_open=gaps[k][0], gap_extend=gaps[k][1],
                           q_len=q_len)
        assert torch.equal(got[k], want)


def test_sw_control_in_bfloat16_misses_the_exact_scores():
    """Scores past 256 have no exact bfloat16 form: the control (the
    reference in bfloat16) reads a gap where the exact comparison has 0."""
    rng = np.random.default_rng(4)
    q = torch.as_tensor(rng.integers(0, 20, 300).astype(np.int32))
    subj = torch.as_tensor(np.stack([q.numpy(), rng.integers(0, 20, 300).astype(np.int32)]))
    lens = torch.tensor([300, 300])
    exact = ref_sw.sw_scores([q], [(5.0, 2.0)], subj, lens)
    low = ref_sw.sw_scores([q], [(5.0, 2.0)], subj, lens, dtype=torch.bfloat16)
    assert float(exact.max()) > 256 and ref_sw.worst_gap(low.float(), exact) > 0


def test_phi3_reference_equals_the_ports_float32_step():
    """Initial weights drawn alike from the seed, and the f32 loss and
    gradients of the port's plain path at the reference's within 1e-5 of
    each leaf's largest gradient (sums in another order)."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params
    from bench.runners.train import _named_leaves, port_config
    c = {**PHI3, **tiny.TRAIN["config"]}
    cfg = port_config(c).replace(dtype="float32", remat=False)
    ours = phi3.init_params(c, 77, "cpu", dtype=torch.float32)
    theirs = _named_leaves(init_params(cfg, 77, device="cpu"))
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    b = gen.lm_batch(77, 0, 2, 32, c["vocab_size"])
    tok, lab = torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"])
    loss, grads = phi3.loss_and_grads(ours, tok, lab, c)
    params = init_params(cfg, 77, device="cpu")
    want_loss, _, want = loss_and_grads(params, {"tokens": tok, "labels": lab}, cfg)
    want = _named_leaves(want)
    assert abs(loss - float(want_loss)) < 1e-5
    for k in grads:
        scale = float(want[k].abs().max())
        assert float((grads[k] - want[k]).abs().max()) <= 1e-5 * scale + 1e-12, k


def test_lm_batch_equals_the_ports_synthetic_batches():
    from repro_torch.configs import ARCHS
    from repro_torch.data import SyntheticLM
    cfg = ARCHS["phi3-mini-3.8b"]
    want = SyntheticLM(cfg, 2, 16, seed=2**33 + 5)(3)
    got = gen.lm_batch(2**33 + 5, 3, 2, 16, cfg.vocab_size)
    assert all(np.array_equal(got[k], want[k]) for k in ("tokens", "labels"))


def test_swissprot_lengths_keep_the_release_statistics():
    """At 2^19 subjects and seed 19 the draws give chip_smoke.py's database
    (183,992,278 residues, as its phase 4 prints): gamma(2, 176) lengths in
    [2, 2000]."""
    db = {"subjects": 1 << 19, "mean_len": 352, "gamma_shape": 2.0, "min_len": 2, "max_len": 2000}
    lens = gen.swissprot_lengths(db, 19)
    assert int(lens.sum()) == 183_992_278
    assert lens.min() >= 2 and lens.max() <= 2000
    assert abs(lens.mean() - 351.5) < 2 and abs(np.median(lens) - 295) < 10
    flat, lens2 = gen.swissprot_db({**db, "subjects": 1000}, 19, "cpu")
    assert flat.numel() == int(lens2.sum()) and 0 <= int(flat.min()) and int(flat.max()) < 20


def test_query_schedule_sends_every_size_once_a_block():
    traffic = {"query_lengths": [144, 189, 497, 1000], "gap_regimes": [[10.0, 2.0], [5.0, 2.0]]}
    for seed in (1, 2**31 + 3):
        s = gen.QuerySchedule(traffic, seed)
        block = [s(i)[:3] for i in range(8, 16)]
        assert sorted(block) == sorted(s.combos)
        assert all(s(i)[3].shape == (s(i)[0],) for i in range(8))
    a, b = gen.QuerySchedule(traffic, 1), gen.QuerySchedule(traffic, 2)
    assert [a(i)[:3] for i in range(8)] != [b(i)[:3] for i in range(8)]


@pytest.mark.parametrize("B,S,tflop", [(2, 4096, 210.9)])
def test_train_flops_reproduce_chip_smoke(B, S, tflop):
    """chip_smoke.py: 210.9 TFLOP for Phi-3-mini at B = 2, S = 4096, 6 x
    3,820,879,872 parameters, as its phase 10 prints.  Its count takes the
    embedding lookup as a product (6·V·d a token) and attends every earlier
    position; the copy leaves the lookup out and keeps the published
    window of 2047 keys."""
    embed = PHI3["vocab_size"] * PHI3["hidden_size"]
    assert work.matmul_params(PHI3) + embed == 3_820_879_872
    full = {**PHI3, "sliding_window": None}
    assert round((work.train_flops(full, B, S) + 6 * embed * B * S) / 1e12, 1) == tflop
    assert work.fa_pairs(4096, 4096, True, None) == 4096 * 4097 // 2
    assert work.fa_pairs(4096, 4096, True, 2047) == 2047 * 2048 // 2 + 2049 * 2047
    assert work.fa_fwd_flops(PHI3, B, S) * 4096 * 4097 // 2 == \
        work.fa_fwd_flops(full, B, S) * work.fa_pairs(4096, 4096, True, 2047)
    assert work.gcups(2e9, 2.0) == 1.0
