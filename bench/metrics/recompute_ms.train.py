"""Device milliseconds a step launched inside the program's
`train.recompute` spans, on autograd's thread: the layer bodies that
remat runs again inside the backward."""
import phases


def read(r):
    return phases.device_ms(r, "train.recompute")
