"""The numbers that decide `correct`, each against its limit.

A cell's limits file names the numbers compared; the others are read
and logged, not compared.

Training (the first `ref_steps` steps of the set-up, the program's and
the reference's, from the same weights and batches):
  loss_gap    the widest |loss − the reference's loss| over the steps
  grad_gap    over the pieces (a layer of a stacked leaf, else a leaf):
              | |g| − |g_ref| | / max(|g_ref|, the median piece's
              |g_ref|), the first step's gradient as the optimizer got it
  change_gap  the same of the weights' change over the steps, over the
              pieces whose reference gradient is at least 1e-3 of the
              median piece's (the others move by round-off alone)
  grad_gap_median, change_gap_median   the median piece's gap, steady
              from seed to seed where the worst piece is a small leaf's
              round-off
Serving:
  logit_gap   the widest amount by which the reference's logit of a
              served token lies below the reference's best
"""
from __future__ import annotations

import statistics

#: a piece whose reference gradient is under this share of the median
#: piece's takes no part in change_gap
GRAD_FLOOR = 1e-3


def piece_gaps(got: dict, ref: dict, keep=None) -> dict:
    """{piece: | |got| − |ref| | / max(|ref|, the median piece's |ref|)}."""
    med = statistics.median(ref.values())
    return {k: abs(got[k] - r) / max(r, med, 1e-30) for k, r in ref.items()
            if keep is None or k in keep}


def _worst(gaps: dict) -> tuple:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def still(ref: dict) -> list:
    """The pieces left out of change_gap: reference gradient under
    GRAD_FLOOR of the median piece's."""
    med = statistics.median(ref["grad"].values())
    return sorted(k for k, v in ref["grad"].items() if v < GRAD_FLOOR * med)


def train_numbers(got: dict, ref: dict) -> dict:
    out = set(still(ref))
    moving = {k for k in ref["grad"] if k not in out}
    grad = piece_gaps(got["grad"], ref["grad"])
    change = piece_gaps(got["change"], ref["change"], moving)
    loss = max(abs(a - b) for a, b in zip(got["loss"], ref["loss"]))
    return {"loss_gap": (loss, None), "grad_gap": _worst(grad),
            "change_gap": _worst(change),
            "grad_gap_median": (statistics.median(grad.values()), None),
            "change_gap_median": (statistics.median(change.values()), None)}


def checks(numbers: dict, limits: dict) -> dict:
    """The numbers the cell's limits file names, each against its limit;
    a number it does not name is read and not compared."""
    out = {}
    for k, lim in limits.items():
        v, where = numbers[k]
        out[k] = {"value": v, "limit": lim, "ok": v <= lim, "where": where}
    return out


def prefill_checks(gaps: list, limits: dict) -> dict:
    return checks({"logit_gap": (max(gaps), None)}, limits)
