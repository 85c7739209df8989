"""Device milliseconds a step launched under autograd's
`FlashAttentionBackward` node: the flash attention backward."""


def read(r):
    t = r.trace
    if t is None:
        return None
    s = t.device_s_under("FlashAttentionBackward")
    return 1e3 * s / r.units if s > 0 else None
