"""Pareto-front exploration (paper Fig. 5; a copy of
``repro.core.pareto`` over the port's ``core.objective``).

Sweep the constraint weight lambda over [0, 2^4]; at each lambda route
every eval prompt, measure aggregate MLM accuracy and expected compute
(mean selected-model size).  The paper's headline: ~5% accuracy traded for
>50% compute.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.library import ModelLibrary
from repro_torch.core.objective import Constraint, routing_scores


def pareto_sweep(pred_losses: np.ndarray, qtable: dict,
                 library: ModelLibrary, constraint: Constraint,
                 lambdas=None) -> dict:
    """pred_losses: (N, n_models) router predictions (or the ground-truth
    Q-table for the oracle front).  Returns per-lambda metrics."""
    if lambdas is None:
        lambdas = np.concatenate([[0.0], np.logspace(-3, 4, 22, base=2.0)])
    sizes = library.sizes()
    acc_tab = qtable["acc"]
    N = pred_losses.shape[0]
    rows = []
    for lam in lambdas:
        scores = np.asarray(routing_scores(pred_losses, [constraint], [lam]))
        choice = scores.argmin(axis=1)
        acc = float(acc_tab[np.arange(N), choice].mean())
        mean_size = float(sizes[choice].mean())
        alloc = np.bincount(choice, minlength=len(library)) / N
        rows.append({"lam": float(lam), "accuracy": acc,
                     "mean_size": mean_size,
                     "size_frac": mean_size / sizes.max(),
                     "alloc": alloc.tolist()})
    return {"lambdas": [r["lam"] for r in rows], "rows": rows}
