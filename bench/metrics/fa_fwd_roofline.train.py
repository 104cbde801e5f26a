"""The flash-attention forward kernel's share of its bound in the traced
steps: 2 products x 2·D FLOPs per unmasked pair (causal, within the
configuration's window) x B·H for every forward launch (the remat
recompute's included; counts/work.py), at 989e12 FLOP/s bf16, over the
device time of ``fa_wgmma_kernel``/``fa_kernel``, in %.  Silent where
the trace holds fewer launches than the program counted (lost records)."""
import re

from bench.counts.work import PEAKS

FWD = re.compile(r"\bfa_(wgmma_)?kernel\b")


def read(trace):
    c = trace.counters
    n = sum(1 for name, _, _ in trace.kernels if FWD.search(name))
    if not n or n != c.get("fa_fwd_launches"):
        return None
    seconds = trace.kernel_s(lambda name: bool(FWD.search(name)))
    return 100.0 * c["fa_fwd_flops"] / PEAKS["bf16_flops_per_s"] / seconds
