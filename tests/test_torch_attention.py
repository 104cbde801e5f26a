"""Attention in the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through ``repro`` (the Pallas kernel in interpret
mode, as the reference's own tests run it, and the jnp model paths) and
through ``repro_torch``, where the flash-attention wrapper runs its plain
PyTorch version.  Tolerances are stated beside each check.  The kernel
itself runs in ``test_torch_gpu.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

CPU = "cpu"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# Kernel tolerance: 2e-5 in f32 and 2e-2 in bf16, the reference's own
# (tests/test_kernels.py:93): the softmax sums are taken in another order.
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a, dtype):
    """One numpy array as (jax array, torch tensor) of the same dtype."""
    jd, td = DT[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,T,D", [
    (1, 2, 2, 64, 64, 16),
    (2, 4, 2, 96, 160, 32),   # GQA + ragged
    (1, 8, 1, 128, 128, 64),  # MQA
])
def test_flash_attention_matches_jax_kernel(dtype, B, H, Hkv, S, T, D):
    q, k, v = _qkv(B * S + T, (B, H, S, D), (B, Hkv, T, D))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jops.flash_attention_op(jq, jk, jv, causal=True, bq=32, bk=64)
    got = ops.flash_attention_op(tq, tk, tv, causal=True, device=CPU)
    plain = fa.fa_plain(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, D)
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(plain), _np(got), atol=0, rtol=0)
    # and the materialised oracle of both packages (f32, 2e-5 / 2e-2)
    oracle = ref.attention_ref(tq.float(), tk.float(), tv.float(), causal=True)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(oracle), _np(jref.attention_ref(*(a.astype(jnp.float32)
                                              for a in (jq, jk, jv)),
                                            causal=True)),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [16, 48])
def test_flash_attention_sliding_window_matches_jax(window):
    q, k, v = _qkv(0, (1, 2, 96, 16), (1, 2, 96, 16))
    want = jops.flash_attention_op(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=True, window=window, bq=32, bk=32)
    got = ops.flash_attention_op(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True, window=window, device=CPU)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)   # f32 kernel tol


def test_flash_attention_matches_model_chunked_path():
    """The port's form of tests/test_kernels.py:109-124: the kernel's plain
    version against the model's chunked attention, on the model's layout;
    3e-5 as there."""
    q, k, v = _qkv(7, (2, 256, 4, 32), (2, 256, 2, 32))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got_model = tattn.attention(tq, tk, tv, causal=True, impl="chunked",
                                q_chunk=64, kv_chunk=64)
    got_kernel = fa.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                    tv.transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(_np(got_model), _np(got_kernel), atol=3e-5)
    want = jattn.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                           impl="chunked", q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(_np(got_model), _np(want), atol=2e-6)


@pytest.mark.parametrize("impl,window,causal_skip,S,T,Hkv,q_offset", [
    ("naive", None, False, 40, 40, 2, 0),
    ("naive", 8, False, 40, 40, 4, 0),
    ("naive", None, False, 16, 40, 2, 24),          # q_offset
    ("chunked", None, False, 300, 300, 2, 0),       # GQA, ragged chunks
    ("chunked", None, True, 300, 300, 4, 0),        # triangular schedule
    ("chunked", 64, False, 300, 300, 1, 0),         # window, MQA
    ("chunked", None, False, 260, 300, 2, 40),      # q_offset
    ("pallas", None, False, 20, 20, 2, 0),          # tiny: the naive dispatch
])
def test_attention_matches_jax(impl, window, causal_skip, S, T, Hkv, q_offset):
    """Model attention in f32 against the reference: 2e-6 (f32 sums over at
    most 300 keys, in the same tiling)."""
    q, k, v = _qkv(S + T, (2, S, 4, 16), (2, T, Hkv, 16))
    kw = dict(causal=True, window=window, impl=impl, q_chunk=128,
              kv_chunk=64, causal_skip=causal_skip, q_offset=q_offset)
    want = jattn.attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    got = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("rolling,window,with_start", [
    (False, None, False), (False, None, True), (False, 5, False),
    (True, None, False),
])
@pytest.mark.parametrize("cache_len", [1, 7, 12])
def test_decode_attention_matches_jax(rolling, window, with_start, cache_len):
    """Single-token attention against a cache, f32: 2e-6."""
    rng = np.random.default_rng(cache_len)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    start = np.array([0, 2, min(cache_len - 1, 5)], np.int32) if with_start else None
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(cache_len),
        window=window, rolling=rolling,
        start_pos=None if start is None else jnp.asarray(start))
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        cache_len, window=window, rolling=rolling,
        start_pos=None if start is None else torch.from_numpy(start))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("bad", ["head_mismatch", "empty", "window"])
def test_flash_attention_wrapper_refuses_bad_input(bad):
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 3, 8, 16))
    kw = {}
    if bad == "empty":
        q, k = torch.zeros((1, 4, 0, 16)), torch.zeros((1, 2, 8, 16))
    elif bad == "window":
        k, kw = torch.zeros((1, 2, 8, 16)), {"window": 0}
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k, **kw)


def _tma(name, t):
    return fa.tma_problem(name, t.shape, t.stride(), t.dtype,
                          t.storage_offset())


@pytest.mark.parametrize("B,S,H,D", [(2, 4096, 32, 80), (1, 1, 4, 16),
                                     (3, 70, 5, 128)])
def test_tma_rule_takes_the_models_views(B, S, H, D):
    """The bf16 kernel's TMA rule on CPU tensors: the model's (B,S,H,D)
    tensors passed as (B,H,S,D) views, and contiguous (B,H,S,D) tensors,
    are taken as they are."""
    x = torch.zeros((B, S, H, D), dtype=torch.bfloat16)
    assert _tma("q", x.transpose(1, 2)) is None
    assert _tma("k", x.transpose(1, 2).contiguous()) is None
    # a k/v slice of a fused projection starts on a 16-byte boundary too
    fused = torch.zeros((B, S, 3 * H * D), dtype=torch.bfloat16)
    k = fused[..., H * D:2 * H * D].reshape(B, S, H, D).transpose(1, 2)
    assert _tma("k", k) is None


@pytest.mark.parametrize("case,why", [
    ("row_stride", r"q\.stride\(2\) = 84 elements = 168 bytes"),
    ("head_stride", r"q\.stride\(1\) = 84 elements = 168 bytes"),
    ("offset", "16-byte boundary"),
    ("float32", "bfloat16"),
    ("last_axis", r"stride\(3\)"),
])
def test_tma_rule_names_what_it_cannot_take(case, why):
    """Rows or heads 168 bytes apart, a start 2 bytes into the storage, a
    float32 tensor or a strided last axis: the rule names the stride."""
    if case == "row_stride":
        t = torch.zeros((1, 4, 20, 84), dtype=torch.bfloat16)[..., :80]
    elif case == "head_stride":
        t = torch.zeros((1, 20, 4, 84), dtype=torch.bfloat16)[..., :80] \
            .transpose(1, 2)
    elif case == "offset":
        t = torch.zeros((1, 4, 20, 88), dtype=torch.bfloat16)[..., 1:81]
    elif case == "float32":
        t = torch.zeros((1, 4, 20, 80))
    else:
        t = torch.zeros((1, 4, 20, 160), dtype=torch.bfloat16)[..., ::2]
    got = _tma("q", t)
    assert got is not None and re.search(why, got), got


def test_tma_rule_ignores_strides_of_size_one_axes():
    """An axis of size 1 is never stepped along, so its stride is free."""
    t = torch.zeros(2048, dtype=torch.bfloat16)
    assert _tma("q", t.as_strided((1, 4, 1, 80), (3, 80, 5, 1))) is None
    assert _tma("q", t.as_strided((1, 4, 2, 80), (3, 160, 84, 1))) \
        is not None
