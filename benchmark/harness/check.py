"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``reference/``) run once the window has
closed, each number beside its limit.

Each loop (``loops/<loop>.py``) works out its own numbers (``numbers``);
``judge`` holds them against the traffic mix's ``limits``. The helpers
here are shared by the loops that follow a fit: ``fit_gaps`` takes each
number by the worst variable, as the gap between the program's norm and
the reference's, over the reference's norm of that variable or of the
median variable, whichever is larger. A variable whose reference
gradient is under a thousandth of the median variable's is left out of
the change (Adam moves it by round-off alone).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst variable's gap of norms, over the larger of its reference
    norm and the median variable's."""
    keep = list(ref) if keep is None else keep
    pn, rn = _norms(prog), _norms(ref)
    median = statistics.median(rn[k] for k in ref)
    return max(abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in keep)


def fit_gaps(prog: dict, ref: dict) -> dict:
    """The fit's three numbers of ``prog`` against ``ref``, each a dict of
    ``losses``, ``grad``, ``start`` and ``end`` (``reference/fit.follow``)."""
    loss_gap = float("inf")
    if len(prog["losses"]) == len(ref["losses"]):
        loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    gnorm = _norms(ref["grad"])
    median = statistics.median(gnorm.values())
    moved = [k for k, v in gnorm.items() if v >= 1e-3 * median]
    change = leaf_gap({k: prog["end"][k] - prog["start"][k] for k in ref["end"]},
                      {k: ref["end"][k] - ref["start"][k] for k in ref["end"]}, moved)
    return {"loss_gap": loss_gap, "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": change}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: each number against its
    limit; a number that is not finite fails."""
    checks = {k: {"value": v, "limit": float(limits[k])} for k, v in numbers.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
