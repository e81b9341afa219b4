"""Model-selection baselines for the Fig. 3a comparison (numpy; a copy
of ``repro.core.baselines``).

The paper compares Tryage to Gorilla and GPT-3.5-Turbo — both select a
model from natural-language model cards, without learned loss prediction.
Offline we implement that class of baseline faithfully-in-kind:

  * ``keyword_router`` — the Gorilla analogue: scores each expert's
    model-card text against surface statistics of the prompt (which
    domain's private sub-vocabulary dominates), then picks the
    best-described match.  No learned loss prediction.
  * ``leaderboard_router`` — picks the single model with best mean
    benchmark accuracy (what an engineer does with a leaderboard).
  * ``random_router`` / ``largest_router`` — control floors.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.library import ModelLibrary
from repro_torch.data.corpus import DOMAINS, DomainCorpus


def oracle_choices(qtable: dict) -> np.ndarray:
    return qtable["loss"].argmin(axis=1)


def random_router(n_prompts: int, n_models: int, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n_models, n_prompts)


def largest_router(library: ModelLibrary, n_prompts: int) -> np.ndarray:
    return np.full(n_prompts, int(library.sizes().argmax()))


def leaderboard_router(qtable_train: dict, n_prompts: int) -> np.ndarray:
    """Best-mean-accuracy model on held-out 'benchmark' data, applied
    uniformly (leaderboard-style selection)."""
    best = int(qtable_train["acc"].mean(axis=0).argmax())
    return np.full(n_prompts, best)


def keyword_router(tokens: np.ndarray, corpus: DomainCorpus,
                   library: ModelLibrary) -> np.ndarray:
    """Gorilla-class baseline: infer the dominant domain of each prompt
    from private-vocabulary hit counts, then pick the expert whose model
    card names that domain (ties -> larger model).  No learned Q."""
    V = corpus.vocab_size
    # map token -> domain by private vocab membership (-1 = shared)
    tok2dom = np.full(V, -1, np.int32)
    for di, d in enumerate(DOMAINS):
        tok2dom[corpus.private_vocab[d]] = di
    doms = tok2dom[tokens]                      # (N, S)
    counts = np.stack([(doms == di).sum(axis=1)
                       for di in range(len(DOMAINS))], axis=1)
    dom_choice = counts.argmax(axis=1)          # (N,)

    # expert affinity for each domain from its model card (train mixture
    # is what the card advertises)
    affinity = np.zeros((len(DOMAINS), len(library)))
    sizes = library.sizes()
    for mi, e in enumerate(library.experts):
        for di, d in enumerate(DOMAINS):
            affinity[di, mi] = e.train_mixture.get(d, 0.0)
    # tie-break toward larger models (Gorilla's observed bias)
    affinity += 1e-9 * (sizes / sizes.max())[None, :]
    return affinity.argmax(axis=1)[dom_choice]


def selection_accuracy(choices: np.ndarray, qtable: dict,
                       tol: float = 0.0) -> float:
    """Fraction of prompts routed to the argmin-loss model (Fig. 3a).

    ``tol`` > 0 counts near-optimal picks (loss within tol of the best) —
    mirrors the paper's lenient 'any evidence' scoring of GPT/Gorilla.
    """
    loss = qtable["loss"]
    best = loss.min(axis=1)
    picked = loss[np.arange(len(choices)), choices]
    return float(np.mean(picked <= best + tol))
