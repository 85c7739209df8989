"""Device milliseconds a step launched inside the program's
`train.forward` span, on its thread: the model's forward and the loss."""
import phases


def read(r):
    return phases.device_ms(r, "train.forward")
