"""The 3xTF32 arithmetic of the SSD backward kernels, on the CPU.

``csrc/ssd_scan_bwd.cu`` runs its f32 products on the tensor cores: each
f32 operand is split into a TF32 high part and a TF32 residual
(``ssd_scan.tf32_split``, as ``cvt.rna.tf32.f32`` rounds), and a product
sums lo·hi + hi·lo + hi·hi per 8-deep step of ``mma.sync.m16n8k8`` in f32.
Here the split is held to its definition, and the 3-term product of
operands drawn like the backward's to the float64 product: it must be as
accurate as a plain f32 product, where one TF32 product is not.
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.kernels.ssd_scan import tf32_split


def _rna_reference(a: np.ndarray) -> np.ndarray:
    """Round normal f32 values to 11 significant bits (10 explicit), ties
    away from zero, in float64 arithmetic."""
    m, e = np.frexp(a.astype(np.float64))          # |m| in [0.5, 1)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_tf32_split_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(20000) * np.exp(rng.uniform(-60, 60, 20000))).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(a))
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()      # at most 10 mantissa bits
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    np.testing.assert_array_equal(hi.numpy(), _rna_reference(a))
    # hi + lo recovers a within 2^-22 |a|
    err = np.abs(a.astype(np.float64) - hi.double().numpy() - lo.double().numpy())
    assert (err <= 2.0 ** -22 * np.abs(a.astype(np.float64))).all()
    # ties go away from zero: 1 + 2^-11 is halfway between two TF32 values
    t = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11], dtype=torch.float32)
    assert tf32_split(t)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9]
    # bf16 values are their own high part
    b = torch.from_numpy(a).to(torch.bfloat16).float()
    hb, lb = tf32_split(b)
    assert torch.equal(hb, b) and lb.eq(0).all()
    # non-finite values pass through
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(tf32_split(inf)[0], inf)
    assert torch.isnan(tf32_split(torch.tensor([float("nan")]))[0]).all()


def _mma_products(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a (m, K) @ b (K, n) as the kernels' m16n8k8 steps sum it: f32
    accumulators, per 8-deep step lo_a·hi_b, then hi_a·lo_b, then hi_a·hi_b
    (terms 3), or hi_a·hi_b alone (terms 1).  Every TF32 product is exact
    in f32, so an 8-deep f32 matmul of the parts is the step's sum.  terms
    0: the f32 operands themselves, summed in the same order (the plain f32
    product, as a SIMT kernel would sum it)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if terms == 0:
        ah, bh = a, b
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        if terms == 3:
            acc = acc + al[:, s] @ bh[s]
            acc = acc + ah[:, s] @ bl[s]
        acc = acc + ah[:, s] @ bh[s]
    return acc


# G ∘ decays down to e^-60 against N(0,1) dy, as G·dy (K = the chunk) and
# the head terms of dB/dC (K = H·P = 5120) multiply them
@pytest.mark.parametrize("K", [64, 256, 1024, 5120])
def test_3xtf32_product_is_f32_accurate(K):
    rng = np.random.default_rng(K)
    g = rng.standard_normal((64, K)) * np.exp(-rng.uniform(0, 60, (64, K)))
    dy = rng.standard_normal((K, 64))
    ref = g @ dy                                     # float64
    a, b = torch.from_numpy(g).float(), torch.from_numpy(dy).float()
    scale = np.abs(ref).max()

    def err(v):
        return float(np.abs(v.double().numpy() - ref).max() / scale)

    e3, e1, e32 = (err(_mma_products(a, b, t)) for t in (3, 1, 0))
    assert e3 <= 2 * e32, (e3, e32)                  # as accurate as an f32 product
    assert e3 <= 1e-5, e3                            # far inside the 1e-4 tolerance
    assert e3 * 100 <= e1, (e3, e1)                  # one TF32 product is not


@pytest.mark.parametrize("x_bf16,bc_bf16", [(False, False), (True, True), (True, False)])
def test_backward_bound_counts_tf32_terms_by_operand_dtype(x_bf16, bc_bf16):
    """``chip_smoke.py``'s 3xTF32 bound: each product of the least work at
    two TF32 terms where an operand is bf16 (its low part is zero), three
    where both are f32."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    b, T, H, P, N, l = 2, 4096, 80, 64, 64, 256
    nc, tri = T // l, l * (l + 1) // 2
    f32, bf = torch.float32, torch.bfloat16
    x, bc = (bf if x_bf16 else f32), (bf if bc_bf16 else f32)
    products = [                          # (multiply-adds a (batch, chunk), operand dtypes)
        (H * P * tri, (f32, x)),          # dy·xᵀ
        (H * P * tri, (f32, f32)),        # G·dy
        (H * l * N * P, (bc, f32)),       # the state gradient C·dy
        (H * l * N * P, (f32, f32)),      # h_inᵀ·dy, dC's head term
        (H * l * N * P, (f32, f32)),      # gᵀ·u, dB's head term
        (H * l * N * P, (f32, bc)),       # g·B
        (N * tri, (f32, bc)),             # dS·B
        (N * tri, (f32, bc)),             # dSᵀ·C
    ]
    want = sum(2 * b * nc * m * (2 if bf in types else 3) for m, types in products)
    got = smoke.ssd_bwd_tf32_flops(b, T, H, P, N, l, x, bc)
    assert got == want
    if not (x_bf16 or bc_bf16):
        assert got == 3 * smoke.ssd_bwd_flops(b, T, H, P, N, l)
    if x_bf16 and bc_bf16:                # Zamba2's training shape: 108.12 GFLOP
        assert abs(got / 1e9 - 108.12) < 0.01
