"""The port's model stack against the JAX package, on the CPU.

Parameters are drawn by the reference's ``init_params`` and carried across
with ``convert.params_from_numpy``, so both packages run the same weights;
token ids are drawn with numpy.  The families of this slice are dense
(phi3), ssm (mamba2) and hybrid (zamba2), at their ``smoke()`` sizes.
Tolerances are stated beside each check.
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

CPU = "cpu"
SLICE = ["zamba2-2.7b", "mamba2-130m", "phi3-mini-3.8b"]


def _close_scaled(got, want, tol, what=""):
    """max |got - want| <= tol · max(1, max |want|)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _pair(arch, dtype="float32"):
    jcfg = JARCHS[arch].smoke().replace(dtype=dtype)
    cfg = ARCHS[arch].smoke().replace(dtype=dtype)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return jcfg, cfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", SLICE)
def test_prefill_and_decode_match_jax(arch):
    """Same weights, same tokens, f32 on both sides: the prefill logits,
    every cache leaf, then three decode steps' logits and cache.  1e-4 of
    each leaf's scale: f32 sums in another order through the smoke model's
    layers (the SSM state carries them across every chunk)."""
    jcfg, cfg, jp, tp = _pair(arch)
    toks = _tokens(cfg, 2, 32)
    jl, jc = jax.jit(lambda p, b: jprefill(p, b, jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    assert tl.shape == (2, cfg.vocab_size) and tl.dtype == torch.float32
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
        step = toks[:, t:t + 1]
        jl, jcc = jstep(jp, {"tokens": jnp.asarray(step)}, jcc, jnp.int32(t))
        tl, tcc = decode_step(tp, {"tokens": torch.from_numpy(step)}, tcc, t, cfg)
        _close_scaled(tl, jl, 1e-4, f"decode logits step {t}")
    for k in tcc:
        _close_scaled(tcc[k], jcc[k], 1e-4, f"decode cache {k}")


@pytest.mark.parametrize("arch", SLICE)
def test_init_params_has_the_reference_tree(arch):
    """Keys, shapes and dtypes of the port's ``init_params`` (and of its
    meta-device spec) equal the reference's tree, in the working bf16."""
    jcfg, cfg = JARCHS[arch].smoke(), ARCHS[arch].smoke()
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(lambda: jinit(jcfg, jax.random.PRNGKey(0))))[0]}
    got = dict(convert._flat(init_params(cfg, 0, device=CPU)))
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in got.items()}
    assert got == want
    spec = {k: (s, str(d).removeprefix("torch."))
            for k, (s, d) in convert._flat(init_params_spec(cfg))}
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


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_arch_decode_runs(arch):
    """The port's form of tests/test_models.py:54-72: one decode step on
    the smoke model gives finite logits and changes the cache."""
    cfg = ARCHS[arch].smoke()
    params = init_params(cfg, 0, device=CPU)
    cache = init_cache(cfg, 2, 20, device=CPU)
    toks = torch.from_numpy(_tokens(cfg, 2, 1))
    logits, cache2 = decode_step(params, {"tokens": toks}, cache, 0, cfg)
    assert torch.isfinite(logits).all()
    diff = sum(float((a.float() - b.float()).abs().sum())
               for a, b in zip(cache.values(), cache2.values()))
    assert diff > 0


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "zamba2-2.7b"])
def test_decode_matches_full_forward(arch):
    """The port's form of tests/test_models.py:75-90 (and on zamba2):
    step-by-step decode over a prompt == the prefill's last logits, bf16
    weights as there, at its 2e-2."""
    cfg = ARCHS[arch].smoke()
    params = init_params(cfg, 0, device=CPU)
    S = 16 if cfg.family == "hybrid" else 12     # zamba2 smoke: chunk 8
    toks = torch.from_numpy(_tokens(cfg, 1, S, seed=5))
    logits_full, _ = prefill(params, {"tokens": toks}, cfg)
    cache = init_cache(cfg, 1, S + 2, device=CPU)
    for t in range(S):
        logits_step, cache = decode_step(params, {"tokens": toks[:, t:t + 1]},
                                         cache, t, cfg)
    torch.testing.assert_close(logits_step, logits_full, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama-3.2-vision-90b",
                                  "musicgen-medium"])
def test_later_families_raise(arch):
    cfg = ARCHS[arch].smoke()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(cfg, 0, device=CPU)


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
