"""Request/Result types and the user-flag mini-language.

The paper folds user constraints into the prompt itself, e.g.
"The capital of California is [blank] [Flag: Smallest model]".  We parse
the same flag surface into constraint weights (lambdas).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

_FLAG_RE = re.compile(r"\[flag:\s*([^\]]+)\]", re.IGNORECASE)

# flag phrase -> (constraint name, lambda)
FLAG_TABLE = {
    "smallest model": ("size", 8.0),
    "small model": ("size", 2.0),
    "prefer small": ("size", 1.0),
    "newest model": ("recency", 4.0),
    "recent model": ("recency", 1.0),
    "best model": (None, 0.0),
}


def parse_flags(text: str) -> dict:
    """Extract constraint weights from [Flag: ...] markers."""
    lambdas: dict[str, float] = {}
    for m in _FLAG_RE.finditer(text):
        phrase = m.group(1).strip().lower()
        entry = FLAG_TABLE.get(phrase)
        if entry and entry[0]:
            lambdas[entry[0]] = max(lambdas.get(entry[0], 0.0), entry[1])
    return lambdas


def lambda_matrix(requests: "list[Request]",
                  constraint_names: list) -> np.ndarray:
    """Per-request constraint weights as the (B, n_c) matrix consumed by
    the fused router kernel; column order follows ``constraint_names``.
    With no constraints, returns (B, 1) zeros to pair with the zero-row
    matrix from ``objective.constraint_matrix``.
    """
    if not constraint_names:
        return np.zeros((len(requests), 1), np.float32)
    lam = np.zeros((len(requests), len(constraint_names)), np.float32)
    for i, r in enumerate(requests):
        for j, name in enumerate(constraint_names):
            lam[i, j] = r.lambdas.get(name, 0.0)
    return lam


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray                 # (S,) masked MLM prompt
    targets: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    lambdas: dict = dataclasses.field(default_factory=dict)
    arrival: Optional[float] = None    # enqueue time (engine clock); the
    #                                    engine stamps it on admission if unset
    priority: int = 0                  # higher flushes first from a full lane
    min_confidence: float = 0.0        # cascade threshold: escalate while the
    #                                    chosen expert's confidence is below
    #                                    this (0 = single-shot, no cascade)


@dataclasses.dataclass
class Result:
    uid: int
    expert: str
    pred_losses: np.ndarray            # router's L-hat over the library
    predictions: np.ndarray            # argmax token at each position
    loss: float | None                 # measured, if targets supplied
    accuracy: float | None
    flops_proxy: float                 # 2 * params * tokens
    latency_s: float                   # true enqueue -> flush latency
    cached: bool = False               # routing decision came from the cache
    flush_reason: str = ""             # target | deadline | drain | fifo
    #                                    (| failed: expert flush failed and
    #                                    fallback could not re-route)
    cascade_depth: int = 0             # escalation steps taken (0 = first pick)
    confidence: float = 1.0            # router confidence in the final expert
    fallback_depth: int = 0            # health-fallback re-selections taken
    #                                    (0 = objective's pick served; monotone
    #                                    over the request's lifetime, route-time
    #                                    fallback + failed-flush re-routes)
    failed: bool = False               # expert execution failed and the request
    #                                    was not served (no fallback available)
