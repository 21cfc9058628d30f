"""The comparison that decides a training run's ``correct``.

The program's first checked steps against the reference's from the same
weights and rows (``reference/train.py``): each step's loss, the first
step's gradient as the optimizer gets it, and the parameters' and the
EMA's change after the last checked step. A gradient or a change is
compared leaf by leaf as a gap of norms, |‖program‖ - ‖reference‖|, over
the larger of the reference leaf's norm and the median leaf's (some
gradients are all but zero); the worst leaf's and the median leaf's are
the numbers compared. Leaves whose first gradient in the reference is
under a thousandth of the median leaf's move by round-off and weight
decay alone, and are left out.
"""

from __future__ import annotations


def leaf_gaps(got: dict, want: dict, leaves) -> dict:
    """Each leaf's gap of norms, |‖got‖ - ‖want‖| over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = {k: float(want[k].double().norm()) for k in leaves}
    med = _median(norms)
    return {k: abs(float(got[k].double().norm()) - norms[k])
            / max(norms[k], med, 1e-30) for k in leaves}


def moving_leaves(ref_grad: dict) -> list:
    """Leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's."""
    norms = {k: float(g.double().norm()) for k, g in ref_grad.items()}
    med = _median(norms)
    return sorted(k for k, v in norms.items() if v >= 1e-3 * med)


def train_gaps(prog: dict, ref: dict, p0: dict) -> dict:
    """Per leaf gaps: ``grad`` (the first step's gradient as the optimizer
    gets it), ``update`` (params minus p0 after the last step) and ``ema``
    (EMA minus p0), over ``moving_leaves``; and ``loss``, each step's
    |loss - reference| over the reference's."""
    leaves = moving_leaves(ref["grad"])

    def change(d):
        return {k: d[k].double() - p0[k].double() for k in leaves}

    return {"loss": [abs(a - b) / max(abs(b), 1e-30)
                     for a, b in zip(prog["loss"], ref["loss"])],
            "grad": leaf_gaps(prog["grad"], ref["grad"], leaves),
            "update": leaf_gaps(change(prog["params"]), change(ref["params"]),
                                leaves),
            "ema": leaf_gaps(change(prog["ema"]), change(ref["ema"]), leaves)}


def _median(d: dict) -> float:
    v = sorted(d.values())
    return v[len(v) // 2]


def train_errors(prog: dict, gaps: dict, ref: dict) -> dict:
    """The numbers a training run compares, from ``gaps`` (``train_gaps``
    of the program against the reference ``ref``): ``loss_gap``, the worst
    checked step's; ``targets_gap``, the worst step's gap of positive
    cells an image (``num_pos_cells``: exact arithmetic on the GT, so it
    says which rows and flips the step saw); ``grad_gap``, ``update_gap``
    and ``ema_gap``, the worst leaf's; and ``grad_median``,
    ``update_median`` and ``ema_median``, the median leaf's."""
    out = {"loss_gap": max(gaps["loss"]),
           "targets_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b
                              in zip(prog["num_pos"], ref["num_pos"]))}
    for k in ("grad", "update", "ema"):
        out[f"{k}_gap"] = max(gaps[k].values())
        out[f"{k}_median"] = _median(gaps[k])
    return out


def worst_leaves(gaps: dict, n: int = 4) -> dict:
    """The ``n`` largest leaf gaps of each kind, for the look at a
    number's cause."""
    return {k: sorted(gaps[k].items(), key=lambda kv: -kv[1])[:n]
            for k in ("grad", "update", "ema")}
