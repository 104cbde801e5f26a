"""The SSD scan and the Mamba2 block in the PyTorch port against the JAX
package, on the CPU.

The same numpy inputs go through ``repro`` (the Pallas SSD kernel in
interpret mode, as the reference's own tests run it, and the jnp model
paths) and through ``repro_torch``, where the SSD wrapper runs its plain
PyTorch version.  Tolerances are stated beside each check.  The kernel
itself runs in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm as tssm

CPU = "cpu"


def _inputs(seed, b, T, H, P, N, with_h0=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, T, H)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    B = rng.standard_normal((b, T, N)).astype(np.float32)
    C = rng.standard_normal((b, T, N)).astype(np.float32)
    h0 = rng.standard_normal((b, H, P, N)).astype(np.float32) if with_h0 else None
    return x, dt, A, B, C, h0


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,T,H,P,N,chunk", [
    (1, 32, 2, 8, 16, 8),
    (2, 64, 3, 8, 16, 16),
    (1, 128, 4, 16, 32, 32),
])
def test_ssd_scan_matches_jax_kernel(dtype, b, T, H, P, N, chunk):
    """The port's ``ssd_scan_op`` and ``ssd_plain`` against the reference's
    Pallas kernel on the same inputs (x, B, C in ``dtype``): 1e-4, the
    reference's f32 kernel tolerance (tests/test_kernels.py:146) — both sides
    compute in f32 from the same bf16 values, sums in another order."""
    x, dt, A, B, C, _ = _inputs(T + H, b, T, H, P, N)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jx, jB, jC = (jnp.asarray(a, jd) for a in (x, B, C))
    tx, tB, tC = (torch.from_numpy(a).to(td) for a in (x, B, C))
    y_j, h_j = jops.ssd_scan_op(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                                chunk=chunk)
    y_t, h_t = ops.ssd_scan_op(tx, torch.from_numpy(dt), torch.from_numpy(A),
                               tB, tC, chunk=chunk, device=CPU)
    assert y_t.dtype == h_t.dtype == torch.float32
    _close(y_t, y_j, 1e-4)
    _close(h_t, h_j, 1e-4)
    y_p, h_p = ssd.ssd_plain(tx, torch.from_numpy(dt), torch.from_numpy(A),
                             tB, tC, chunk)
    assert torch.equal(y_p, y_t) and torch.equal(h_p, h_t)
    # the token-by-token oracle of the port (f32 inputs): 1e-4 as above
    y_r, h_r = ref.ssd_ref(tx.float(), torch.from_numpy(dt), torch.from_numpy(A),
                           tB.float(), tC.float())
    _close(y_r, y_t, 1e-4)
    _close(h_r, h_t, 1e-4)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(compute, with_h0):
    """``ssd_chunked`` with and without ``h0``, in both compute dtypes.
    f32 products: 1e-5 (the same chunked algorithm, f32 sums of at most 16
    terms).  bf16 products: 6e-2 relative to the output's scale — the two
    frameworks round C·Bᵀ and the gated scores to bf16 at the same points
    but sum in another order first, so an operand may round to its
    neighbour (one bf16 ulp, 2^-8 relative)."""
    x, dt, A, B, C, h0 = _inputs(9, 2, 64, 3, 8, 16, with_h0)
    jcd, tcd = getattr(jnp, compute), getattr(torch, compute)
    y_j, h_j = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                                chunk=16, compute_dtype=jcd,
                                h0=None if h0 is None else jnp.asarray(h0))
    y_t, h_t = tssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                                chunk=16, compute_dtype=tcd,
                                h0=None if h0 is None else torch.from_numpy(h0))
    if compute == "float32":
        _close(y_t, y_j, 1e-5)
        _close(h_t, h_j, 1e-5)
    else:
        scale = float(np.abs(np.asarray(y_j)).max())
        assert np.abs(y_t.numpy() - np.asarray(y_j)).max() <= 6e-2 * scale
        _close(h_t, h_j, 1e-5)   # the state never goes through bf16


def test_ssd_reference_matches_jax():
    """The sequential recurrence, with h0: 1e-5 (the same f32 recurrence)."""
    x, dt, A, B, C, h0 = _inputs(3, 2, 24, 3, 8, 16, with_h0=True)
    y_j, h_j = jssm.ssd_reference(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                                  h0=jnp.asarray(h0))
    y_t, h_t = tssm.ssd_reference(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                                  h0=torch.from_numpy(h0))
    _close(y_t, y_j, 1e-5)
    _close(h_t, h_j, 1e-5)


@pytest.mark.parametrize("bad,err", [("chunk", ValueError), ("shape", ValueError),
                                     ("compute", TypeError)])
def test_ssd_scan_refuses_bad_input(bad, err):
    x, dt, A, B, C, _ = (torch.from_numpy(a) if a is not None else None
                         for a in _inputs(0, 1, 24, 2, 8, 16))
    kw = {"chunk": 16 if bad == "chunk" else 8}
    if bad == "shape":
        A = A[:1]
    if bad == "compute":
        kw["compute_dtype"] = torch.float16
    with pytest.raises(err):
        ssd.ssd_scan(x, dt, A, B, C, **kw)


def _ssm_params(arch):
    jcfg = JARCHS[arch].smoke().replace(dtype="float32")
    cfg = ARCHS[arch].smoke().replace(dtype="float32")
    jp = jssm.ssm_init(jax.random.PRNGKey(1), jcfg)
    tp = {k: convert.tensor_from_numpy(np.asarray(v), device=CPU)
          for k, v in jp.items()}
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_apply_and_decode_match_jax(arch):
    """The Mamba2 block over a sequence (with its cache), then one decode
    step from that cache, f32 with converted params: 1e-5."""
    jcfg, cfg, jp, tp = _ssm_params(arch)
    u = np.random.default_rng(4).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    out_j, c_j = jssm.ssm_apply(jp, jnp.asarray(u), jcfg, return_cache=True)
    out_t, c_t = tssm.ssm_apply(tp, torch.from_numpy(u), cfg, return_cache=True)
    _close(out_t, out_j, 1e-5)
    for k in ("h", "conv"):
        _close(c_t[k], c_j[k], 1e-5)
    u1 = u[:, :1] * 0.5
    d_j, n_j = jssm.ssm_decode(jp, jnp.asarray(u1), c_j, jcfg)
    d_t, n_t = tssm.ssm_decode(tp, torch.from_numpy(u1), c_t, cfg)
    _close(d_t, d_j, 1e-5)
    for k in ("h", "conv"):
        _close(n_t[k], n_j[k], 1e-5)
    # an empty cache of the port's own has the reference's shapes
    empty = tssm.init_ssm_cache(2, cfg, torch.float32, CPU)
    ref_empty = jssm.init_ssm_cache(2, jcfg)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: tuple(v.shape) for k, v in ref_empty.items()}
