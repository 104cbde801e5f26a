"""The flash-attention backward kernels' share of their bound in the
traced steps: 5 products x 2·D FLOPs per unmasked pair (causal, within
the configuration's window) x B·H for every backward launch
(counts/work.py), at 989e12 FLOP/s bf16, over the device time of the
``fa_bwd_*`` kernels (three a launch), in %.  Silent where the trace
holds fewer of them than the program launched."""
from bench.counts.work import PEAKS

KERNELS_PER_LAUNCH = 3


def read(trace):
    c = trace.counters
    n = sum(1 for name, _, _ in trace.kernels if "fa_bwd_" in name)
    if not n or n != KERNELS_PER_LAUNCH * c.get("fa_bwd_launches", 0):
        return None
    seconds = trace.kernel_s(lambda name: "fa_bwd_" in name)
    return 100.0 * c["fa_bwd_flops"] / PEAKS["bf16_flops_per_s"] / seconds
