"""Device time of the kernels launched under the program's
``record_function("train.mamba")`` ranges (each Mamba2 mixer, in_proj
through out_proj: its forward, the remat recompute and the backward), per
traced step (each kernel once, ``bench.spans``), in ms."""
from bench.spans import span_s


def read(trace):
    seconds = span_s(trace, "train.mamba")
    steps = trace.counters.get("steps")
    if not seconds or not steps:
        return None
    return 1e3 * seconds / steps
