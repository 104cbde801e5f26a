"""Device time of the kernels launched under the program's
``record_function("train.shared")`` ranges (each application of a shared
block: the concatenation, attention, the MLP with its adapter and the
layer's linear; forward, remat recompute and backward), per traced step
(each kernel once, ``bench.spans``), in ms."""
from bench.spans import span_s


def read(trace):
    seconds = span_s(trace, "train.shared")
    steps = trace.counters.get("steps")
    if not seconds or not steps:
        return None
    return 1e3 * seconds / steps
