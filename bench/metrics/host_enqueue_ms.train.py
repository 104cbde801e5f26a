"""Host clock per traced step from the call of the program's train step
to its return, before any synchronisation: the time the host takes to
enqueue a step, in ms."""


def read(trace):
    spans = trace.counters.get("enqueue_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
