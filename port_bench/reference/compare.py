"""The comparison that decides `correct` for a training cell.

Both sides give the same readings of their first training iterations: the
first optimizer step's loss, that step's gradient as the optimizer got it
(worked out from Adam's first moment after the step), and each parameter
leaf's change over the checked iterations.  The numbers compared:

  loss    |program - reference| / |reference| of the first step's loss;
  grad    by the worst leaf: | |g_prog| - |g_ref| | over the larger of |g_ref|
          and the median leaf's |g_ref|;
  change  the same of the leaves' changes, over the leaves whose reference
          gradient is at least a thousandth of the median leaf's (a leaf
          with a gradient nought to rounding moves under Adam by round-off
          alone).

A program whose step leaves the parameters unchanged reads change = 1 on
every leaf whose own change is at least the median's.  A number that is not
finite reads infinity.  Why these and not the later iterations' losses:
PERF.md (the adaptive-KL step size and the contacts turn a rounding-level
difference into a large one from the second iteration on).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

NUMBERS = ("loss", "grad", "change")


def _norms(leaves: Dict[str, torch.Tensor], names: List[str]) -> List[float]:
    return [float(torch.linalg.vector_norm(leaves[n].double())) for n in names]


def _worst(gaps) -> float:
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def _worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                names: List[str]) -> float:
    kept = list(zip(_norms(prog, names), _norms(ref, names)))
    med = statistics.median(b for _, b in kept)
    return _worst(abs(a - b) / max(b, med) for a, b in kept)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """{number: value} from the two sides' readings: `loss` a float, `grad`
    and `change` {leaf name: tensor}, matched by name."""
    if set(prog["grad"]) != set(ref["grad"]) or set(prog["change"]) != set(ref["change"]):
        raise ValueError("the two sides name different parameter leaves")
    names = sorted(ref["grad"])
    grads = _norms(ref["grad"], names)
    med = statistics.median(grads)
    moved = [n for n, g in zip(names, grads) if g >= 1e-3 * med]
    return {"loss": _worst([abs(prog["loss"] - ref["loss"]) / abs(ref["loss"])]),
            "grad": _worst_leaf(prog["grad"], ref["grad"], names),
            "change": _worst_leaf(prog["change"], ref["change"], moved)}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit."""
    return all(values[k] <= limits[k] for k in NUMBERS)


def detail(prog: dict, ref: dict, top: int = 3) -> dict:
    """Where the numbers come from (for calibration): each iteration's loss
    gap, both sides' closing step sizes, and the leaves with the widest
    gradient and change gaps."""
    out = {"iteration_loss": [abs(a - b) / abs(b) for a, b in
                              zip(prog["iteration_loss"], ref["iteration_loss"])],
           "lr": [prog["lr"], ref["lr"]]}
    for key in ("grad", "change"):
        names = sorted(ref[key])
        p, r = _norms(prog[key], names), _norms(ref[key], names)
        med = statistics.median(r)
        gaps = sorted(((abs(a - b) / max(b, med), n) for n, a, b in zip(names, p, r)),
                      reverse=True)
        out[key] = [[n, g] for g, n in gaps[:top]]
    return out
