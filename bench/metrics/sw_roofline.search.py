"""The Smith-Waterman kernels' share of their bound over the traced
searches: the real, unpadded cells of the searches (Σ |Q|·|D|) at the
card's 67e12 cells/s (counts/peaks.json, with its reason), over the device
time of the ``sw_warp_kernel``/``sw_kernel`` launches.  Silent where the
trace holds fewer of them than the program launched (lost records)."""
import re

from bench.counts.work import PEAKS

SW = re.compile(r"\bsw_(warp_)?kernel\b")


def read(trace):
    n = sum(1 for name, _, _ in trace.kernels if SW.search(name))
    if not n or n != trace.counters.get("sw_launches"):
        return None
    seconds = trace.kernel_s(lambda name: bool(SW.search(name)))
    return 100.0 * trace.counters["sw_cells"] / PEAKS["sw_cells_per_s"] / seconds
