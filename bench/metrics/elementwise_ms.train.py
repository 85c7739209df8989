"""Device milliseconds a step in ATen's elementwise and reduction
kernels (names holding `elementwise_kernel` or `reduce_kernel`): the
models' eager pointwise work."""


def _eager(name):
    return "elementwise_kernel" in name or "reduce_kernel" in name


def read(r):
    t = r.trace
    if t is None or not t.kernels:
        return None
    return 1e3 * t.device_s(_eager) / r.units
