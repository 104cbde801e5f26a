"""The share of the traced searches' wall in which the card ran no
kernel: 1 - (union of the kernels' intervals) / window, in %."""


def read(trace):
    return trace.idle_pct()
