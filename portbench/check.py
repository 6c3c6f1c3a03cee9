"""The numbers that decide ``correct``, each against the limit its cell's
limits file sets.

- ``loss_gap``: over the first steps, the largest ``|loss - ref| / |ref|``.
- ``grad1_gap`` and ``delta3_gap``: by the worst leaf, the gap between the
  program's norm of that leaf and the reference's (the first gradient as
  the optimizer holds it after step 1; the leaf's change after step 3),
  over the larger of the reference's norm of that leaf and of the median
  leaf.  Leaves whose reference norm is under a thousandth of the median
  leaf's are left out: their values move by round-off alone (the median is
  taken over the leaves the reference moves at all; at the first step the
  zero scale on each block's last BatchNorm leaves every leaf before it in
  the block exactly still).
- ``logit_gap``: over the sampled rows, the largest ``||logits - ref|| /
  ||ref||``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

SKIP_BELOW = 1e-3


def worst_leaf_gap(program: Mapping[str, float], reference: Mapping[str, float]
                   ) -> Tuple[float, str, int]:
    """(gap, worst leaf, leaves counted)."""
    moved = np.array([v for v in reference.values() if v > 0])
    if moved.size == 0:
        raise ValueError("the reference moved no leaf")
    median = float(np.median(moved))
    worst, name, counted = 0.0, "", 0
    for leaf, ref in reference.items():
        if ref < SKIP_BELOW * median:
            continue
        counted += 1
        gap = abs(program[leaf] - ref) / max(ref, median)
        if gap > worst or not name:
            worst, name = gap, leaf
    return worst, name, counted


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def train_numbers(program: Dict, reference: Dict) -> Dict[str, Dict]:
    """``program`` and ``reference``: ``losses``, ``grad1``, ``delta``."""
    g1, g1_leaf, g1_n = worst_leaf_gap(program["grad1"], reference["grad1"])
    d3, d3_leaf, d3_n = worst_leaf_gap(program["delta"], reference["delta"])
    return {"loss_gap": {"value": loss_gap(program["losses"], reference["losses"])},
            "grad1_gap": {"value": g1, "leaf": g1_leaf, "leaves": g1_n},
            "delta3_gap": {"value": d3, "leaf": d3_leaf, "leaves": d3_n}}


def logit_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """``program`` and ``reference``: (rows, classes)."""
    diff = np.linalg.norm(program.astype(np.float64) - reference.astype(np.float64), axis=1)
    return float((diff / np.linalg.norm(reference.astype(np.float64), axis=1)).max())


def judge(numbers: Dict[str, Dict], limits: Mapping[str, Dict]) -> bool:
    """Set each number's ``limit``; True when every number is within it.  A
    number that is not finite fails."""
    ok = True
    for name, entry in numbers.items():
        limit = float(limits[name]["limit"])
        entry["limit"] = limit
        value = entry["value"]
        if not (np.isfinite(value) and value <= limit):
            ok = False
    return ok
