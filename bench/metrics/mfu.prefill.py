"""A prefill request's share of the card's bf16 peak: the model FLOPs of
the requests the window completed (frozen count) over 989
TFLOP/s times the window's host time."""
from frozen.peaks import BF16_FLOP_PER_S


def read(r):
    w = r.window
    if not w["count"]:
        return None
    return 100.0 * w["model_flops"] / (BF16_FLOP_PER_S * w["elapsed_s"])
