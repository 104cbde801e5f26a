"""The port's ``zamba2`` family (Zamba2 at its published equations) on the
CPU: its loss and every leaf's gradient against the benchmark's plain
float32 reference (``bench/reference/zamba2.py``) at a small size, the
shared blocks' gradient as the sum over their uses, the alternation of
the memory blocks, the grouped SSD against the sequential recurrence, the
``hybrid`` family left bit for bit as it was, prefill/decode refused, and
the profiler ranges ``train.mamba`` and ``train.shared`` over the backward.
This family has no counterpart in the JAX package, so nothing here
imports it."""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.zamba2_7b import CONFIG
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models import zamba2 as Z
from repro_torch.models.ssm import ssd_reference
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(**kw):
    """12 layers (the published pattern's first two hybrid layers), 2
    memory blocks, 2 B/C groups, adapter rank 8, float32."""
    return CONFIG.smoke().replace(dtype="float32", **kw)


def _batch(cfg, seed=3, B=2, S=32):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
            for k in ("tokens", "labels")}


def _ref_config(cfg):
    """The benchmark's configuration keys (Hugging Face names) of ``cfg``."""
    return {"hidden_size": cfg.d_model, "mamba_expand": cfg.ssm_expand,
            "num_hidden_layers": cfg.n_layers, "layers_block_type": list(cfg.layer_types),
            "n_mamba_heads": cfg.ssm_heads, "mamba_headdim": cfg.ssm_headdim,
            "mamba_d_state": cfg.ssm_state, "mamba_ngroups": cfg.ssm_groups,
            "mamba_d_conv": cfg.ssm_conv, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "attention_head_dim": cfg.hdim,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "adapter_rank": cfg.adapter_rank, "num_mem_blocks": cfg.n_mem_blocks,
            "chunk_size": cfg.ssm_chunk, "rms_norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta}


def _named(tree):
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for group in ("mamba", "shared", "hybrid"):
        for k, v in tree[group].items():
            for i, t in enumerate(v.unbind(0)):
                out[f"{group}.{i}.{k}"] = t
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_family_matches_the_plain_reference(remat):
    """The same weights from the seed; the loss within 1e-6 (relative)
    and every leaf's gradient within 1e-5 of its largest entry (f32 sums in
    another order, the SSD chunked in another way)."""
    from bench.reference import zamba2 as ref
    cfg = _smoke(remat=remat)
    c = _ref_config(cfg)
    assert cfg.layer_kinds().count("hybrid") == 2
    ours = _named(init_params(cfg, 11, device="cpu"))
    theirs = ref.init_params(c, 11, "cpu", dtype=torch.float32)
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    b = _batch(cfg)
    loss, grads = ref.loss_and_grads(theirs, b["tokens"], b["labels"], c)
    want_loss, _, want = loss_and_grads(init_params(cfg, 11, device="cpu"), b, cfg)
    want = _named(want)
    assert abs(loss - float(want_loss)) <= 1e-6 * abs(loss)
    for k in grads:
        scale = float(want[k].abs().max())
        assert scale > 0, k
        assert float((grads[k] - want[k]).abs().max()) <= 1e-5 * scale, k


def test_a_shared_leaf_gradient_is_the_sum_over_its_uses():
    """At 24 layers (4 hybrid layers: blocks 0, 1, 0, 1) the tied blocks'
    gradients equal the sums of an untied copy's, one block per use."""
    cfg = _smoke(n_layers=24)
    assert cfg.n_hybrid == 4
    params = init_params(cfg, 7, device="cpu")
    untied_cfg = cfg.replace(n_mem_blocks=4)
    untied = dict(params, shared={k: v[[0, 1, 0, 1]].clone()
                                  for k, v in params["shared"].items()})
    b = _batch(cfg, 5)
    loss, _, g = loss_and_grads(params, b, cfg)
    loss_u, _, gu = loss_and_grads(untied, b, untied_cfg)
    assert float(loss) == float(loss_u)
    for k in params["shared"]:
        want = gu["shared"][k][[0, 2]].sum(0), gu["shared"][k][[1, 3]].sum(0)
        for blk in (0, 1):
            torch.testing.assert_close(g["shared"][k][blk], want[blk],
                                       rtol=1e-5, atol=1e-7)
            assert float(gu["shared"][k][blk].abs().max()) > 0


def test_hybrid_layer_i_runs_memory_block_i_mod_2(monkeypatch):
    cfg = _smoke(n_layers=24)
    params = init_params(cfg, 1, device="cpu")
    seen = []
    shared = Z._shared

    def spy(x, e, ps, ph, positions, c):
        seen.append(ps["wq"].data_ptr())
        return shared(x, e, ps, ph, positions, c)

    monkeypatch.setattr(Z, "_shared", spy)
    loss_and_grads(params, _batch(cfg), cfg)
    blocks = [params["shared"]["wq"][b].data_ptr() for b in range(2)]
    assert seen == [blocks[i % 2] for i in range(4)]


def test_grouped_ssd_by_one_call_per_group_equals_the_recurrence():
    """Two groups of B/C: one chunked call per group's heads against
    ``ssd_reference`` head by head with the head's group, within 1e-5."""
    g = torch.Generator().manual_seed(2)
    b, T, H, P, N, G = 2, 24, 6, 4, 5, 2
    x = torch.randn(b, T, H, P, generator=g)
    dt = torch.rand(b, T, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) - 0.1
    B = torch.randn(b, T, G, N, generator=g)
    C = torch.randn(b, T, G, N, generator=g)
    got = Z.grouped_ssd(x, dt, A, B, C, chunk=8)
    for h in range(H):
        grp = h // (H // G)
        want, _ = ssd_reference(x[:, :, h:h + 1], dt[:, :, h:h + 1], A[h:h + 1],
                                B[:, :, grp], C[:, :, grp])
        torch.testing.assert_close(got[:, :, h:h + 1], want, rtol=1e-5, atol=1e-5)


# sha256 of the hybrid family's smoke loss and gradients (zamba2-2.7b's
# smoke config, seed 5, one thread), as the commit before this family read
HYBRID_DIGEST = "e15df79f9702b7ea0d0907106c044895fdfec3769b8a2fba0ce3a91b8297169a"


@pytest.mark.parametrize("remat", [False, True])
def test_hybrid_family_is_bit_identical_to_before(remat):
    from repro_torch.configs import ARCHS
    cfg = ARCHS["zamba2-2.7b"].smoke().replace(remat=remat)
    params = init_params(cfg, 5, device="cpu")
    rng = np.random.default_rng(5)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int64))
         for k in ("tokens", "labels")}
    loss, _, grads = loss_and_grads(params, b, cfg)
    h = hashlib.sha256(loss.float().numpy().tobytes())
    for t in tree_leaves(grads):
        h.update(t.float().contiguous().numpy().tobytes())
    assert h.hexdigest() == HYBRID_DIGEST


def test_preset_holds_the_published_layout_and_sizes():
    assert CONFIG.layer_kinds().count("hybrid") == 13 and CONFIG.n_layers == 81
    assert [i for i, k in enumerate(CONFIG.layer_kinds()) if k == "hybrid"][:6] == \
        [6, 11, 17, 23, 29, 35]
    assert CONFIG.ssm_heads == 112 and CONFIG.conv_dim == 7168 + 256
    assert Z.param_count(CONFIG.replace(n_layers=36)) == 3_708_247_360


def test_prefill_and_decode_wait_for_the_serving_cell():
    cfg = _smoke()
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    for call in (lambda: prefill(params, {"tokens": tokens}, cfg),
                 lambda: decode_step(params, {"tokens": tokens[:, :1]}, {}, 0, cfg),
                 lambda: init_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match=Z.SERVING_CELL):
            call()


def _ancestors(ev):
    up = ev.cpu_parent
    while up is not None:
        yield up.name
        up = up.cpu_parent


def test_spans_cover_the_mixers_and_shared_blocks_backward():
    """In a profiled step (remat on) every product of a mixer's xBC
    projection (conv_dim wide) that the backward runs (its two gradients
    and the recompute) is under ``train.mamba``, every one of an adapter's
    (rank 12: its first matrix and both halves of its second) under
    ``train.shared``, the cross
    entropy's under neither; profiling leaves the numbers as they are."""
    from torch.profiler import ProfilerActivity, profile
    cfg = _smoke(remat=True, vocab_size=384, adapter_rank=12)
    params = init_params(cfg, 4, device="cpu")
    b = _batch(cfg, 6)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        loss, _, grads = loss_and_grads(params, b, cfg)
    back = [ev for ev in prof.events() if ev.name == "aten::mm"
            and any("MmBackward0" in a for a in _ancestors(ev))]

    def with_side(n):
        return [ev for ev in back if any(n in s for s in ev.input_shapes if s)]
    mixer, shared, ce = with_side(cfg.conv_dim), with_side(12), with_side(384)
    # two gradients a product, and the remat recompute inside the backward
    assert len(mixer) == 3 * cfg.n_layers and len(shared) == 3 * 3 * cfg.n_hybrid and ce
    assert all("train.mamba" in _ancestors(ev) for ev in mixer)
    assert all("train.shared" in _ancestors(ev) for ev in shared)
    assert not any({"train.mamba", "train.shared"} & set(_ancestors(ev)) for ev in ce)
    loss0, _, grads0 = loss_and_grads(init_params(cfg, 4, device="cpu"), b, cfg)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(grads), tree_leaves(grads0)))
