"""The SSD forward kernels' share of their bound in the traced steps: the
bound of every forward launch (the remat recompute's included), from the
configuration's sizes alone (counts/zamba2.py: max of the chunked
algorithm's products at the bf16 rate and the inputs and outputs at the
memory rate), over the device time of the five ``ssd_*_kernel`` passes a
launch, in %.  Silent where the trace holds other than five of them a
launch the program counted."""
import re

FWD = re.compile(r"\bssd_(cumsum|cb|state|pass|scan)_kernel\b")
KERNELS_PER_LAUNCH = 5


def read(trace):
    c = trace.counters
    n = sum(1 for name, _, _ in trace.kernels if FWD.search(name))
    if not n or n != KERNELS_PER_LAUNCH * c.get("ssd_fwd_launches", 0):
        return None
    seconds = trace.kernel_s(lambda name: bool(FWD.search(name)))
    return 100.0 * c["ssd_fwd_bound_s"] / seconds
