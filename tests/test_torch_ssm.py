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


TILE = 64   # the CUDA kernel's row and column tile


def _five_pass(x, dt, A, B, C, l, h0=None, cd=torch.float32):
    """The five passes of ``csrc/ssd_scan.cu`` in eager torch, one step
    each, with the kernel's scratch layouts and rounding points: the
    specification the CUDA passes follow.  Scratch starts as NaN, so a value
    read that no pass wrote shows up in the result."""
    b, T, H, P = x.shape
    N = B.shape[-1]
    nc, nt = T // l, -(-l // TILE)
    nan = float("nan")

    def rnd(t):
        return t.to(cd).float()

    xr = x.float().reshape(b, nc, l, H, P)
    dtr = dt.float().reshape(b, nc, l, H)
    Br, Cr = B.float().reshape(b, nc, l, N), C.float().reshape(b, nc, l, N)
    rows = [slice(t * TILE, min(l, (t + 1) * TILE)) for t in range(nt)]
    # pass 1: cs (b, H, nc, l) of the f32 products dt·A, summed in f64; a
    # difference cs_i - cs_j is taken in f64, then rounded to f32 for exp
    cs = torch.cumsum((dtr * A.float()).double(), dim=2).permute(0, 3, 1, 2)

    def diff(i, j):                                              # index tuples
        return (cs[i] - cs[j]).float()
    # pass 2: C·Bᵀ once per (b, chunk), stored transposed (b, nc, j, i);
    # only tiles with j-tile <= i-tile are written
    cbt = torch.full((b, nc, l, l), nan)
    for ti, i in enumerate(rows):
        for j in rows[:ti + 1]:
            cbt[:, :, j, i] = rnd(torch.einsum("bcjn,bcin->bcji", rnd(Br[:, :, j]),
                                               rnd(Cr[:, :, i])))
    # pass 3: each chunk's own state (b, nc, H, N, P), unrounded
    w = torch.exp(diff((..., slice(l - 1, l)), (...,))) * dtr.permute(0, 3, 1, 2)
    st = torch.einsum("bcjn,bhcj,bcjhp->bchnp", Br, w, xr)
    # pass 4: in place, the state entering each chunk; the last carry is h
    carried = (torch.zeros((b, H, N, P)) if h0 is None
               else h0.float().transpose(-1, -2))
    for c in range(nc):
        own = st[:, c].clone()
        st[:, c] = carried
        carried = carried * torch.exp(cs[:, :, c, -1].float())[..., None, None] + own
    # pass 5: y per 64-row tile of i, reading CBᵀ tiles j <= i only
    y = torch.full((b, nc, l, H, P), nan)
    xdt = rnd(xr * dtr[..., None])                               # (b, nc, l, H, P)
    pos = torch.arange(l)
    for i in rows:
        jend = i.stop
        off = torch.einsum("bcin,bchnp->bcihp", Cr[:, :, i], st) * \
            torch.exp(cs[..., i].float()).permute(0, 2, 3, 1)[..., None]
        seg = diff((..., None, i), (..., slice(None, jend), None))     # (b,H,nc,j,i)
        causal = pos[:jend, None] <= pos[None, i]
        g = torch.where(causal, rnd(cbt[:, None, :, :jend, i] * torch.exp(seg)), 0.0)
        y[:, :, i] = off + torch.einsum("bhcji,bcjhp->bcihp", g, xdt[:, :, :jend])
    return y.reshape(b, T, H, P), carried.transpose(-1, -2)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,T,H,P,N,chunk", [
    (1, 32, 2, 8, 16, 8),      # chunks of 8, under one tile
    (2, 96, 3, 8, 16, 96),     # one chunk (nc = 1) in two ragged row tiles
    (1, 192, 2, 16, 32, 96),   # chunks of 96, not a multiple of 64
])
def test_ssd_five_pass_decomposition_matches_jax(compute, with_h0, b, T, H, P,
                                                 N, chunk):
    """The CUDA kernel's five-pass decomposition, written out in eager torch
    (``_five_pass``), against the reference's ``ssd_chunked`` (both compute
    dtypes, with and without h0), the reference's Pallas kernel in interpret
    mode (f32 products, no h0: its contract) and the port's ``ssd_plain``,
    on the same numpy inputs.  1e-4 with f32 products (tests/test_kernels.py:146;
    sums in another order); 5e-2 with bf16 products, the reference's bf16
    tolerance (a sum in another order can round an operand to its bf16
    neighbour).  The state never goes through bf16: 1e-4 in both."""
    x, dt, A, B, C, h0 = _inputs(T + N, b, T, H, P, N, with_h0)
    tcd, jcd = getattr(torch, compute), getattr(jnp, compute)
    tol = 1e-4 if compute == "float32" else 5e-2
    targs = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = _five_pass(*targs, chunk, h0=th0, cd=tcd)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    y_j, h_j = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                                chunk=chunk, compute_dtype=jcd,
                                h0=None if h0 is None else jnp.asarray(h0))
    _close(y, y_j, tol)
    _close(h, h_j, 1e-4)
    y_p, h_p = ssd.ssd_plain(*targs, chunk, h0=th0, compute_dtype=tcd)
    _close(y, y_p.numpy(), tol)
    _close(h, h_p.numpy(), 1e-4)
    if compute == "float32" and h0 is None:
        y_k, h_k = jops.ssd_scan_op(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                                    chunk=chunk)
        _close(y, y_k, 1e-4)
        _close(h, h_k, 1e-4)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_f32_forms_against_f64_witness_at_chunk_1024(with_h0):
    """Chunk 1024 with steep decays (A = -13.5, so cs reaches about -1e3):
    ``ssd_plain`` with ``compute_dtype=torch.float64`` evaluates every step
    in float64 and is the witness.  The kernels' decomposition, which sums
    cs in float64 and takes each difference there, holds it within 1e-4.
    The reference's f32 form (the JAX ``ssd_chunked``, and ``ssd_plain`` in
    f32, which copies it) misses it: each f32 step of a sum near -1e3 rounds
    by ~3e-5, and exp(cs_i - cs_j) carries that.  So on the card, chunks
    longer than 256 with f32 products are held against the witness."""
    b, T, H, P, N, l = 1, 2048, 4, 64, 128, 1024
    x, dt, _, B, C, h0 = _inputs(3, b, T, H, P, N, with_h0)
    A = np.full(H, -13.5, np.float32)
    targs = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y_w, h_w = ssd.ssd_plain(*targs, l, h0=th0, compute_dtype=torch.float64)
    assert y_w.dtype == h_w.dtype == torch.float64
    assert float(torch.cumsum(targs[1][0, :l, 0].double() * -13.5, 0)[-1]) < -900

    def err(got, want):     # the largest |got - want| / (1 + |want|)
        got = torch.from_numpy(np.array(got, np.float64))
        return float(((got - want).abs() / (1 + want.abs())).max())

    y, h = _five_pass(*targs, l, h0=th0)
    assert err(y, y_w) <= 1e-4 and err(h, h_w) <= 1e-4
    y_p, h_p = ssd.ssd_plain(*targs, l, h0=th0)
    y_j, h_j = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                                chunk=l, h0=None if h0 is None else jnp.asarray(h0))
    assert err(y_p, y_w) > 1e-4 and err(y_j, y_w) > 1e-4


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
