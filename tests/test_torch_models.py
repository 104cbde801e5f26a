"""The port's model stack against the JAX package, on the CPU.

Parameters are drawn by the reference's ``init_params`` and carried across
with ``convert.params_from_numpy``, so both packages run the same weights;
token ids (audio: frame embeddings; vlm: vision embeddings too) are drawn
with numpy.  Every family runs at its ``smoke()`` size: dense (phi3,
deepseek-coder, starcoder2, mistral-nemo), ssm (mamba2), hybrid (zamba2),
moe (mixtral with its sliding window, kimi-k2 with its shared expert), vlm
(llama-3.2-vision) and audio (musicgen).  Tolerances are stated beside
each check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import config as jconfig
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import config as tconfig
from repro_torch.models import (decode_step, init_cache, init_params,
                                init_params_spec, prefill)
from repro_torch.tree import tree_leaves_with_path

CPU = "cpu"
SLICE = ["zamba2-2.7b", "mamba2-130m", "phi3-mini-3.8b", "deepseek-coder-33b",
         "starcoder2-7b", "mistral-nemo-12b", "mixtral-8x7b", "kimi-k2-1t-a32b",
         "llama-3.2-vision-90b", "musicgen-medium"]
# Padded heads (masked) and vocab (sliced): the smoke configs pad nothing.
PADDED = {"starcoder2-7b": dict(pad_heads_to=8, pad_vocab_to=384),
          "zamba2-2.7b": dict(pad_heads_to=8),
          "musicgen-medium": dict(pad_heads_to=8)}


def _close_scaled(got, want, tol, what=""):
    """max |got - want| <= tol · max(1, max |want|)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _pair(arch, dtype="float32", **over):
    jcfg = JARCHS[arch].smoke().replace(dtype=dtype, **over)
    cfg = ARCHS[arch].smoke().replace(dtype=dtype, **over)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return jcfg, cfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batch(cfg, B, S, seed=0):
    """The model's inputs as numpy: token ids, or frame embeddings for
    audio; vlm adds the vision embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        b = {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    else:
        b = {"tokens": _tokens(cfg, B, S, seed)}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_patches, cfg.vision_dim)).astype(np.float32)
    return b


def _step(batch, t):
    """The inputs of position t (the vision stream goes with every step)."""
    return {k: v if k == "vision_embeds" else v[:, t:t + 1] for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _logits_shape(cfg, B):
    return (B, cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks else \
        (B, cfg.vocab_size)


def _prefill_and_decode_match(arch, **over):
    jcfg, cfg, jp, tp = _pair(arch, **over)
    batch = _batch(cfg, 2, 32)
    jl, jc = jax.jit(lambda p, b: jprefill(p, b, jcfg))(jp, _jnp(batch))
    tl, tc = prefill(tp, _torch(batch), cfg)
    assert tuple(tl.shape) == _logits_shape(cfg, 2) and tl.dtype == torch.float32
    _close_scaled(tl, jl, 1e-4, "prefill logits")
    assert sorted(tc) == sorted(jc)
    for k in tc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        _close_scaled(tc[k], jc[k], 1e-4, f"prefill cache {k}")
    jcc = jinit_cache(jcfg, 2, 40)
    tcc = init_cache(cfg, 2, 40, device=CPU)
    assert {k: tuple(v.shape) for k, v in tcc.items()} == \
        {k: v.shape for k, v in jcc.items()}
    jstep = jax.jit(lambda p, b, c, l: jdecode(p, b, c, l, jcfg))
    for t in range(3):
        step = _step(batch, t)
        jl, jcc = jstep(jp, _jnp(step), jcc, jnp.int32(t))
        tl, tcc = decode_step(tp, _torch(step), tcc, t, cfg)
        _close_scaled(tl, jl, 1e-4, f"decode logits step {t}")
    for k in tcc:
        _close_scaled(tcc[k], jcc[k], 1e-4, f"decode cache {k}")


@pytest.mark.parametrize("arch", SLICE)
def test_prefill_and_decode_match_jax(arch):
    """Same weights, same inputs, f32 on both sides: the prefill logits,
    every cache leaf, then three decode steps' logits and cache.  1e-4 of
    each leaf's scale: f32 sums in another order through the smoke model's
    layers (the SSM state carries them across every chunk)."""
    _prefill_and_decode_match(arch)


@pytest.mark.parametrize("arch", sorted(PADDED))
def test_padded_heads_and_vocab_match_jax(arch):
    """The same check with attention heads padded (and masked) and, for
    starcoder2, the vocabulary padded (and sliced off the logits): 1e-4 of
    the scale, as above."""
    _prefill_and_decode_match(arch, **PADDED[arch])


@pytest.mark.parametrize("S", [32, 12])
def test_sliding_window_prefill_then_decode_matches_jax(S):
    """Mixtral's window (16 at smoke size): prefill S tokens, then 3 decode
    steps from the prefill's rolling cache.  At S = 32 the steps run past
    the window and evict the oldest rows.  At S = 12 (< window) the
    reference's own rule is at fault: its prefill keeps the last
    min(window, S) rows and ``decode_step`` writes at ``cache_len % T``,
    which here overwrites a row still inside the window, so prefill(S) plus
    a step is not prefill(S + 1).  The port keeps that rule for parity, and
    this case pins it.  1e-4 of the scale, as above."""
    jcfg, cfg, jp, tp = _pair("mixtral-8x7b")
    assert cfg.sliding_window == 16
    batch = _batch(cfg, 2, S + 3, seed=4)
    head = {k: v[:, :S] for k, v in batch.items()}
    jl, jc = jprefill(jp, _jnp(head), jcfg)
    tl, tc = prefill(tp, _torch(head), cfg)
    _close_scaled(tl, jl, 1e-4, "prefill logits")
    assert tc["k"].shape[2] == min(S, 16)
    jstep = jax.jit(lambda p, b, c, l: jdecode(p, b, c, l, jcfg))
    for t in range(S, S + 3):
        step = _step(batch, t)
        jl, jc = jstep(jp, _jnp(step), jc, jnp.int32(t))
        tl, tc = decode_step(tp, _torch(step), tc, t, cfg)
        _close_scaled(tl, jl, 1e-4, f"decode logits at {t}")
    for k in tc:
        _close_scaled(tc[k], jc[k], 1e-4, f"decode cache {k}")


@pytest.mark.parametrize("arch", SLICE)
def test_init_params_has_the_reference_tree(arch):
    """Keys, shapes and dtypes of the port's ``init_params`` (and of its
    meta-device spec) equal the reference's tree, in the working bf16."""
    jcfg, cfg = JARCHS[arch].smoke(), ARCHS[arch].smoke()
    want = {jax.tree_util.keystr(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0))))[0]}
    got = dict(tree_leaves_with_path(init_params(cfg, 0, device=CPU)))
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in got.items()}
    assert got == want
    spec = {k: (s, str(d).removeprefix("torch."))
            for k, (s, d) in tree_leaves_with_path(init_params_spec(cfg))}
    assert spec == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_and_param_counts_match_the_reference(arch):
    """Every config of the registry is a field-for-field copy, and the
    parameter counts agree exactly."""
    got, want = dataclasses.asdict(ARCHS[arch]), dataclasses.asdict(JARCHS[arch])
    assert got == want
    assert tconfig.param_count(ARCHS[arch]) == jconfig.param_count(JARCHS[arch])
    assert tconfig.active_param_count(ARCHS[arch]) == \
        jconfig.active_param_count(JARCHS[arch])
    assert ARCHS[arch].layer_kinds() == JARCHS[arch].layer_kinds()
    assert dataclasses.asdict(ARCHS[arch].smoke()) == \
        dataclasses.asdict(JARCHS[arch].smoke())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_decode_runs(arch):
    """The port's form of tests/test_models.py:54-72, for every config:
    prefill and one decode step on the smoke model give finite logits of
    the right shape, and the step changes the cache."""
    cfg = ARCHS[arch].smoke()
    params = init_params(cfg, 0, device=CPU)
    batch = _torch(_batch(cfg, 2, 8))
    logits, _ = prefill(params, batch, cfg)
    assert tuple(logits.shape) == _logits_shape(cfg, 2)
    assert torch.isfinite(logits).all()
    cache = init_cache(cfg, 2, 20, device=CPU)
    logits, cache2 = decode_step(params, _step(batch, 0), cache, 0, cfg)
    assert tuple(logits.shape) == _logits_shape(cfg, 2)
    assert torch.isfinite(logits).all()
    diff = sum(float((a.float() - b.float()).abs().sum())
               for a, b in zip(cache.values(), cache2.values()))
    assert diff > 0


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "zamba2-2.7b", "mixtral-8x7b",
                                  "llama-3.2-vision-90b", "musicgen-medium"])
def test_decode_matches_full_forward(arch):
    """The port's form of tests/test_models.py:75-90 (and on zamba2 and
    the moe, vlm and audio families): step-by-step decode over a prompt ==
    the prefill's last logits, bf16 weights as there, at its 2e-2."""
    cfg = ARCHS[arch].smoke()
    params = init_params(cfg, 0, device=CPU)
    S = 16 if cfg.family == "hybrid" else 12     # zamba2 smoke: chunk 8
    batch = _torch(_batch(cfg, 1, S, seed=5))
    logits_full, _ = prefill(params, batch, cfg)
    cache = init_cache(cfg, 1, S + 2, device=CPU)
    for t in range(S):
        logits_step, cache = decode_step(params, _step(batch, t), cache, t, cfg)
    torch.testing.assert_close(logits_step, logits_full, atol=2e-2, rtol=2e-2)


def test_unknown_family_raises():
    cfg = ARCHS["phi3-mini-3.8b"].smoke().replace(family="diffusion")
    for fn in (lambda: init_params(cfg, 0, device=CPU), lambda: init_params_spec(cfg),
               lambda: init_cache(cfg, 1, 8, device=CPU)):
        with pytest.raises(ValueError, match="unknown model family"):
            fn()


def test_stacked_init_draws_in_the_same_order_in_every_dtype():
    """The f32 model is the bf16 model's draws unrounded: every bf16 leaf
    is its f32 counterpart rounded (the consistency checks on the card
    rely on this), and the stacked leaves are filled, not left empty."""
    for arch in ("mixtral-8x7b", "llama-3.2-vision-90b", "zamba2-2.7b"):
        cfg = ARCHS[arch].smoke()
        bf = dict(tree_leaves_with_path(init_params(cfg, 7, device=CPU)))
        f32 = dict(tree_leaves_with_path(init_params(cfg.replace(dtype="float32"),
                                                     7, device=CPU)))
        assert bf.keys() == f32.keys()
        for k in bf:
            assert torch.equal(bf[k], f32[k].to(bf[k].dtype)), (arch, k)
            assert bool(torch.isfinite(f32[k]).all()), (arch, k)
        leaf = next(v for k, v in f32.items()
                    if k.startswith(("['blocks']", "['self']", "['ssm']"))
                    and v.dim() > 3)
        assert not torch.equal(leaf[0], leaf[-1])       # distinct draws per layer


def _small_qkv():
    g = torch.Generator().manual_seed(0)
    return [torch.randn((1, 2, 8, 16), generator=g) for _ in range(3)]


def _small_ssd():
    g = torch.Generator().manual_seed(0)
    return (torch.randn((1, 16, 2, 8), generator=g), torch.rand((1, 16, 2), generator=g),
            -torch.rand((2,), generator=g), torch.randn((1, 16, 4), generator=g),
            torch.randn((1, 16, 4), generator=g))


ENTRY_POINTS = {
    "init_params": lambda dev: init_params(ARCHS["zamba2-2.7b"].smoke(), 0, device=dev),
    "init_cache": lambda dev: init_cache(ARCHS["zamba2-2.7b"].smoke(), 1, 8, device=dev),
    "ServeEngine": lambda dev: ServeEngine(ARCHS["phi3-mini-3.8b"].smoke(), device=dev),
    "flash_attention_op": lambda dev: ops.flash_attention_op(*_small_qkv(), device=dev),
    "ssd_scan_op": lambda dev: ops.ssd_scan_op(*_small_ssd(), chunk=8, device=dev),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_stay_on_the_card(name, monkeypatch):
    """Without a card, ``device=None`` raises instead of running on the
    CPU; ``device="cpu"`` is the explicit request for the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name](None)
    assert ENTRY_POINTS[name](CPU) is not None
