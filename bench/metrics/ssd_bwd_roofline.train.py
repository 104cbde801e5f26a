"""The SSD backward kernels' share of their bound in the traced steps: the
bound of every backward launch (counts/zamba2.py: max of twice the chunked
algorithm's products at the bf16 rate and the inputs and outputs at the
memory rate) over the device time of the eight ``ssd_bwd_*_kernel``
kernels a launch, in %.  Silent where the trace holds other than eight
of them a launch the program counted."""
import re

BWD = re.compile(r"\bssd_bwd_\w+_kernel\b")
KERNELS_PER_LAUNCH = 8


def read(trace):
    c = trace.counters
    n = sum(1 for name, _, _ in trace.kernels if BWD.search(name))
    if not n or n != KERNELS_PER_LAUNCH * c.get("ssd_bwd_launches", 0):
        return None
    seconds = trace.kernel_s(lambda name: bool(BWD.search(name)))
    return 100.0 * c["ssd_bwd_bound_s"] / seconds
