"""The whole train step's share of the card's bf16 peak: the frozen
``train_flops`` count of a step (counts/work.py) x the traced steps, at
989e12 FLOP/s, over the traced steps' wall on the host clock, in %."""
from bench.counts.work import PEAKS


def read(trace):
    c = trace.counters
    if not c.get("steps") or not trace.busy_s:
        return None
    return 100.0 * c["train_flops"] * c["steps"] / PEAKS["bf16_flops_per_s"] / trace.window_s
