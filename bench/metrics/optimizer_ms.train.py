"""Device milliseconds a step launched inside the program's
`train.optimizer` span: AdamW's update, the gradient clip with it."""
import phases


def read(r):
    return phases.device_ms(r, "train.optimizer")
