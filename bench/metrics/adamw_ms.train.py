"""Device time of the kernels launched under the program's
``record_function("train.adamw")`` range (the optimizer update), per
traced step, in ms."""


def read(trace):
    seconds = trace.span_s("train.adamw")
    steps = trace.counters.get("steps")
    if not seconds or not steps:
        return None
    return 1e3 * seconds / steps
