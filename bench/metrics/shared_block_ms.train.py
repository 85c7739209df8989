"""Device milliseconds a step launched inside the program's
`model.shared_block` spans, on the span's own thread: the zamba2 shared
blocks' invocations with their linears, in the forward (the caller's
thread) and in the recompute (autograd's thread).  None where the
program opens no such span."""
import phases

NAME = "model.shared_block"


def read(r):
    t = r.trace
    if t is None or not any(op[3] == NAME for op in t.ops):
        return None
    return phases.device_ms(r, NAME)
