"""The comparison that decides ``correct``: the program's three checked
steps against the reference's, by the numbers below that the cell's file
(``workloads/<cell>.json``) gives a limit, and the count of non-finite
losses in the window, held to 0.

A leaf's gap is |‖program‖ − ‖reference‖| over the larger of the
reference's norm of that leaf and of the median leaf. A leaf's angle is
1 − cos between the program's tensor and the reference's (1 where one
side is zero and the other is not). The moving leaves are those whose
reference gradient is at least a thousandth of the median leaf's (a leaf
below, such as a bias under a normalisation, moves by round-off alone).

* ``sup_loss_gap``: the first step's supervised losses (one a model), the
  largest |program − reference| / |reference|.
* ``grad_gap_median``: the first gradient as the optimizer takes it (L2
  included), the median leaf's gap. TF32 convolutions put the worst
  leaves a tenth or more apart on every seed (their error grows through
  the backward).
* ``head_grad_gap``: the same first gradient, the worst gap among the
  classifier's leaves (the layer that makes the logits, one layer from the
  loss; the configuration's ``classifier``).
* ``grad_angle_median``: the same first gradient, the median moving
  leaf's angle: a gradient that points elsewhere, at the norm it should
  have, shows here. (The worst leaf's angle reads TF32's rounding grown
  through the backward, as the worst leaf's gap does.)
* ``head_grad_angle``: the same first gradient, the worst angle among the
  classifier's leaves.
* ``change_angle_median``: each parameter's change over the three steps,
  the median moving leaf's angle.
* ``stats_gap_median``: each running statistic's change over the first
  step (the forwards' batch statistics), the median leaf's gap.
* ``update_gap``: each parameter's change over the three steps, the worst
  moving leaf's gap.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

from .program import Readings

GRADIENT_FLOOR = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[set] = None) -> List[float]:
    """The leaves' gaps, sorted; inf for a leaf the program lacks or reads NaN."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return [0.0]
    median = statistics.median(ref[n] for n in names)
    out = []
    for n in names:
        p = prog.get(n, math.nan)
        scale = max(ref[n], median)
        gap = abs(p - ref[n]) / scale if scale > 0 else (0.0 if p == 0 else math.inf)
        out.append(math.inf if math.isnan(gap) else gap)
    return sorted(out)


def percentile(sorted_values: List[float], share: float) -> float:
    return sorted_values[min(len(sorted_values) - 1, int(share * len(sorted_values)))]


def angles(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
           keep: set) -> List[float]:
    """The moving leaves' angles, sorted; inf for a leaf the program lacks
    or reads NaN."""
    out = []
    for n in sorted(keep):
        if n not in prog:
            out.append(math.inf)
            continue
        r = ref[n].double().flatten()
        p = prog[n].to(r.device, torch.float64).flatten()
        pn, rn = float(p.norm()), float(r.norm())
        if pn == 0 or rn == 0:
            angle = 0.0 if pn == rn else 1.0
        else:
            angle = 1.0 - float(torch.dot(p, r)) / (pn * rn)
        out.append(math.inf if math.isnan(angle) else angle)
    return sorted(out) or [0.0]


def compare(prog: Readings, ref: Readings, classifier: str) -> Dict[str, float]:
    k = prog.sup_terms
    lp, lr = prog.losses[0, :k], ref.losses[0, :k]
    if prog.losses.shape != ref.losses.shape:
        sup_loss_gap = math.inf
    else:
        gap = (lp - lr).abs() / lr.abs().clamp_min(1e-12)
        sup_loss_gap = math.inf if bool(gap.isnan().any()) else float(gap.max())
    median_grad = statistics.median(ref.first_grad.values())
    moving = {n for n, g in ref.first_grad.items() if g >= GRADIENT_FLOOR * median_grad}
    head = [n for n in ref.first_grad if n.split(".", 1)[1].startswith(classifier + ".")]
    head_gaps = [abs(prog.first_grad.get(n, math.nan) - ref.first_grad[n])
                 / max(ref.first_grad[n], median_grad) for n in head]
    head_gap = math.inf if not head_gaps or any(map(math.isnan, head_gaps)) else max(head_gaps)
    grads = prog.vectors["first_grad"], ref.vectors["first_grad"]
    return {"sup_loss_gap": sup_loss_gap,
            "grad_gap_median": percentile(leaf_gaps(prog.first_grad, ref.first_grad), 0.5),
            "head_grad_gap": head_gap,
            "grad_angle_median": percentile(angles(*grads, moving), 0.5),
            "head_grad_angle": angles(*grads, set(head))[-1],
            "change_angle_median": percentile(
                angles(prog.vectors["change"], ref.vectors["change"], moving), 0.5),
            "stats_gap_median": percentile(leaf_gaps(prog.stats_change1, ref.stats_change1), 0.5),
            "update_gap": leaf_gaps(prog.change, ref.change, moving)[-1]}
