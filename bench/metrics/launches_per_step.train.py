"""Kernel launches a step: the runtime's launch calls in the trace over
the steps traced (eager dispatch launches one kernel an op)."""


def read(r):
    t = r.trace
    if t is None or not t.n_launches:
        return None
    return t.n_launches / r.units
