"""Device time of the kernels launched under the program's
``record_function("train.ce")`` ranges (the cross entropy's chunks: their
forward, its recompute and the backward's nodes, the f32 logits' products
among them), per traced step, in ms."""


def read(trace):
    seconds = trace.span_s("train.ce")
    steps = trace.counters.get("steps")
    if not seconds or not steps:
        return None
    return 1e3 * seconds / steps
