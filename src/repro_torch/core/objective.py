"""The routing objective (paper eq. 1 / eq. 4).

    M-hat = argmin_i [ L-hat(z, M_i) + sum_j lambda_j * C_j(M_i) ]

``repro.core.objective`` in numpy on the host: constraints, the
routing score and its argmin (``route``), the confidence map and the
cascade / fallback walks.  The serving engine's argmin runs in the
router kernels.

Constraints are scalar functions of expert metadata; the user supplies
weights lambda_j (via flags in the prompt, or programmatically).  With a
ground-truth Q table this is the Oracle router R_O; with router-predicted
losses it is the predictive router R_P.

Confidence-aware extension: the router's loss predictions carry no
notion of their own reliability, so a misprediction commits the prompt
to the wrong expert with full conviction.  Given a per-expert
predictive-uncertainty estimate sigma (``core.router`` uncertainty
head), this module derives a calibrated confidence score
``1 / (1 + sigma)`` in (0, 1), an optional confidence-penalized variant
of the routing score (``routing_scores(..., uncertainty, risk_weight)``),
and the abstention/escalation rule the serving cascade applies: when the
chosen expert's confidence falls below a request's threshold, walk the
size-ordered escalation ladder to the next-larger expert until the
router is confident enough (or the bounded depth / largest expert is
reached).  The walk is cycle-safe by construction — positions in the
ladder strictly increase.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.library import ModelLibrary


@dataclasses.dataclass
class Constraint:
    name: str
    values: np.ndarray  # (n_models,) scalar C_j(M_i)

    @staticmethod
    def from_fn(name: str, library: ModelLibrary, fn: Callable) -> "Constraint":
        return Constraint(name, np.array([fn(e) for e in library.experts], float))


def size_constraint(library: ModelLibrary) -> Constraint:
    """Linear size penalty C(M_i) = |W_i| / max|W_i| (paper §Pareto)."""
    sizes = library.sizes()
    return Constraint("size", sizes / sizes.max())


def log_size_constraint(library: ModelLibrary) -> Constraint:
    """Log-size penalty C(M_i) = log|W_i| / max log|W_i|."""
    sizes = library.sizes()
    return Constraint("log_size", np.log(sizes) / np.log(sizes).max())


def recency_constraint(library: ModelLibrary) -> Constraint:
    """Penalize stale models: C = 1 - recency."""
    return Constraint("recency", 1.0 - library.recencies())


def routing_scores(pred_losses, constraints: Sequence[Constraint],
                   lambdas: Sequence[float], uncertainty=None,
                   risk_weight: float = 0.0) -> np.ndarray:
    """(..., n_models) combined routing loss L_R = L-hat + sum_j
    lambda_j C_j, in the predictions' type.  With ``uncertainty`` (per-
    expert sigma, the shape of ``pred_losses``) and ``risk_weight > 0``
    experts the router distrusts are handicapped by ``risk_weight *
    sigma``; without, the original objective exactly."""
    if len(constraints) != len(lambdas):
        raise ValueError(f"{len(constraints)} constraints, "
                         f"{len(lambdas)} lambdas")
    score = np.asarray(pred_losses)
    for c, lam in zip(constraints, lambdas):
        score = score + lam * np.asarray(c.values, score.dtype)
    if uncertainty is not None and risk_weight:
        score = score + risk_weight * np.asarray(uncertainty, score.dtype)
    return score


def route(pred_losses, constraints: Sequence[Constraint] = (),
          lambdas: Sequence[float] = (), uncertainty=None,
          risk_weight: float = 0.0) -> np.ndarray:
    """argmin of the routing objective over the last axis of
    pred_losses (..., n_models); ties go to the lower index."""
    return np.argmin(routing_scores(pred_losses, constraints, lambdas,
                                    uncertainty, risk_weight), axis=-1)


def constraint_matrix(constraints: Sequence[Constraint],
                      n_models: int) -> np.ndarray:
    """Stack constraint value vectors into the (n_c, M) matrix the fused
    router kernel consumes.  With no constraints, returns one zero row so
    the kernel's BlockSpec stays well-formed (the matching lambda column
    is zero too, so the decision is unaffected).
    """
    if not constraints:
        return np.zeros((1, n_models), np.float32)
    return np.stack([np.asarray(c.values, np.float32) for c in constraints])


# ------------------------------------------------- confidence & cascade

def confidence_scores(uncertainty):
    """Map per-expert sigma >= 0 to a calibrated confidence in (0, 1].

    ``1 / (1 + sigma)`` is monotone-decreasing in sigma and unit-free:
    sigma is in the same log-loss units as L-hat, so confidence 0.5
    means "the router expects to be off by about one full unit of loss".
    """
    return 1.0 / (1.0 + np.maximum(np.asarray(uncertainty, np.float64), 0.0))


def escalation_order(library: ModelLibrary) -> list:
    """Expert indices sorted by ascending size — the cascade ladder.

    Ties keep library order (stable sort), so the ladder is a strict
    total order and escalation cannot revisit an expert."""
    return [int(i) for i in
            np.argsort(library.sizes(), kind="stable")]


def fallback_choice(scores, healthy, available, choice: int,
                    order: Sequence[int], max_depth: int,
                    ) -> tuple[int, int, bool]:
    """Health-aware fallback: final ``(expert, depth, degraded)`` for one
    request whose objective-chosen expert may be down or saturated.

    ``scores`` is the request's constrained routing score vector
    ``L-hat + sum_j lambda_j C_j`` (n_models,); ``healthy`` and
    ``available`` are boolean masks over the library (``available`` =
    healthy *and* not overloaded — the set the serving layer is willing
    to route new traffic to).  Starting from the objective's ``choice``:

    * If the choice is available (or fallback is disabled via
      ``max_depth <= 0``) it passes through untouched, depth 0 — the
      all-healthy fast path is a no-op by construction.
    * Otherwise the chain walks: exclude the current pick, re-score the
      same objective over the remaining experts (argmin of ``scores``,
      ties to the lowest index), and repeat while the fresh pick is
      still unavailable, up to ``max_depth`` exclusions.  Because each
      step takes the global argmin of the non-excluded set, the first
      *available* expert the walk reaches is exactly the argmin of the
      objective restricted to available experts — fallback never
      re-ranks the healthy field, it only removes the sick one
      (property-tested bit-for-bit against that masked re-score in
      ``tests/test_fallback.py``).
    * If the walk exhausts its budget (or every expert is unavailable),
      *graceful degraded mode*: serve the smallest healthy expert
      (first healthy rung of the size-sorted ``order``), overloaded or
      not — keeping the system answering beats honouring the objective.
      With no healthy expert at all the smallest expert overall is
      returned; the caller decides whether to serve or fail it.

    ``depth`` counts expert re-selections (0 = original pick served)
    and is monotone along the chain; a degraded pick that lands on a
    different expert counts as one more step.
    """
    if max_depth <= 0 or available[choice]:
        return int(choice), 0, False
    s = np.asarray(scores, np.float64)
    cur = int(choice)
    excluded = {cur}
    depth = 0
    while depth < max_depth and len(excluded) < len(s):
        cand = [i for i in range(len(s)) if i not in excluded]
        cur = min(cand, key=lambda i: (s[i], i))
        depth += 1
        if available[cur]:
            return cur, depth, False
        excluded.add(cur)
    # degraded: smallest healthy expert, else smallest expert overall
    final = next((int(i) for i in order if healthy[i]), int(order[0]))
    if final != cur:
        depth += 1
    return final, depth, True


def cascade_choice(choice: int, confidence, min_confidence: float,
                   order: Sequence[int], max_depth: int,
                   scores=None) -> tuple[int, int]:
    """Abstention/escalation rule: final (expert, depth) for one request.

    Starting from the objective's ``choice``, abstain and escalate while
    the router's confidence in the current expert is below
    ``min_confidence``, for at most ``max_depth`` steps.  Each step
    targets a *strictly larger* expert (later in the size-sorted
    ``order``): the literal next rung by default, or — when the
    request's constrained routing ``scores`` (n_models,) are supplied —
    the router-preferred larger expert, i.e. the best-scoring one among
    those above the current rung.  Router-preferred escalation spends
    the extra parameters where the router expects them to help instead
    of walking blindly into a wrong-domain specialist.

    ``min_confidence <= 0`` disables the cascade (single-shot behaviour,
    depth 0).  Bounded and cycle-safe either way: the ladder position
    strictly increases and the walk stops at the largest expert.
    """
    if min_confidence <= 0.0 or max_depth <= 0:
        return int(choice), 0
    conf = np.asarray(confidence, np.float64)
    pos = order.index(int(choice))
    depth = 0
    while (conf[order[pos]] < min_confidence and pos + 1 < len(order)
           and depth < max_depth):
        if scores is None:
            pos += 1
        else:
            rest = order[pos + 1:]
            s = np.asarray(scores, np.float64)
            pos += 1 + int(np.argmin([s[i] for i in rest]))
        depth += 1
    return int(order[pos]), depth
