"""Share of the traced window in which no operation ran on the device:
1 - (union of device activity) / the window."""


def read(r):
    t = r.trace
    if t is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
