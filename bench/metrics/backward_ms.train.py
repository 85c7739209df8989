"""Device milliseconds a step launched while the program's
`train.backward` span is open, from any thread (the span is the
caller's; autograd's own thread launches the work), less the recompute
inside it (`recompute_ms.train`): the backward's own kernels."""
import phases


def read(r):
    during = phases.device_ms(r, "train.backward", any_thread=True)
    if during is None:
        return None
    return during - phases.device_ms(r, "train.recompute")
