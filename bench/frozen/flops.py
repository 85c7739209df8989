"""Model FLOPs of a step: matrix-product work, 2·m·n·k, by layer type,
per token, times the tokens (the PaLM / Megatron convention).  A frozen
copy of the program's `flops.accounting` rules, read from a
configuration file's "as_run" sizes, so that a change to the program's
counts cannot move `mfu.*`.

A train step is a forward and a backward of twice its work, 3 F; the
recompute of rematerialised layers is not model work and is left out.
"""
from __future__ import annotations

from reference.models import family


def forward_flops(c: dict, batch: int, seq: int) -> float:
    """Matrix-product FLOPs of one forward over batch × seq tokens: the
    family's blocks (`flops_per_token` of `reference/families/<family>.py`)
    and the head."""
    per_tok = family(c).flops_per_token(c, seq)
    return (per_tok + 2 * c["d_model"] * c["vocab_size"]) * (batch * seq)


def train_step_flops(c: dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(c, batch, seq)
