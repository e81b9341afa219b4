"""Synthetic multi-domain corpus — the offline stand-in for the Pile.

Each domain is an order-1 Markov chain over a shared vocabulary with
 (i) a domain-private high-frequency sub-vocabulary,
 (ii) domain-specific transition sparsity (code is highly structured,
      common-crawl is diffuse),
 (iii) structural motifs (bracket pairs for code, digit runs for math).

These properties make per-domain statistics genuinely different, so expert
models trained on biased mixtures acquire differential per-prompt MLM loss
— reproducing the premise of Tryage Fig. 2 — while prompts remain
unlabeled at routing time, which is exactly the paper's learning problem.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PAD, MASK, BOS = 0, 1, 2
N_SPECIAL = 4

DOMAINS = ("github", "uspto", "pubmed", "freelaw", "dm_math",
           "stackexchange", "books", "commoncrawl")

# per-domain (branching factor, private-vocab weight, motif)
_DOMAIN_PROFILE = {
    "github":        (4,  0.75, "brackets"),
    "uspto":         (8,  0.70, "legalese"),
    "pubmed":        (8,  0.70, "latinate"),
    "freelaw":       (10, 0.60, "legalese"),
    "dm_math":       (3,  0.80, "digits"),
    "stackexchange": (6,  0.55, "brackets"),
    "books":         (14, 0.45, None),
    "commoncrawl":   (20, 0.30, None),
}


@dataclasses.dataclass
class DomainCorpus:
    vocab_size: int = 512
    seed: int = 0
    shared_frac: float = 0.35   # fraction of vocab shared by all domains

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        usable = np.arange(N_SPECIAL, V)
        n_shared = int(len(usable) * self.shared_frac)
        self.shared_vocab = usable[:n_shared]
        rest = usable[n_shared:]
        splits = np.array_split(rest, len(DOMAINS))
        self.private_vocab = {d: s for d, s in zip(DOMAINS, splits)}

        # build per-domain transition tables: for each token, a small set of
        # plausible successors with Zipf-ish weights.
        self.tables = {}
        for d in DOMAINS:
            branch, priv_w, motif = _DOMAIN_PROFILE[d]
            drng = np.random.default_rng(
                rng.integers(0, 2**31))
            succ = np.zeros((V, branch), np.int32)
            for t in range(V):
                n_priv = max(1, int(round(branch * priv_w)))
                cand_priv = drng.choice(self.private_vocab[d], size=n_priv)
                cand_shared = drng.choice(self.shared_vocab,
                                          size=branch - n_priv)
                succ[t] = np.concatenate([cand_priv, cand_shared])
            w = 1.0 / np.arange(1, branch + 1) ** 1.2
            self.tables[d] = (succ, w / w.sum(), motif)

    # ---------------------------------------------------------------

    def sample_tokens(self, domain: str, batch: int, seq: int,
                      rng: np.random.Generator) -> np.ndarray:
        succ, w, motif = self.tables[domain]
        branch = succ.shape[1]
        out = np.empty((batch, seq), np.int32)
        cur = rng.choice(self.private_vocab[domain], size=batch)
        out[:, 0] = cur
        choices = rng.choice(branch, size=(batch, seq), p=w)
        for s in range(1, seq):
            cur = succ[cur, choices[:, s]]
            out[:, s] = cur
        if motif == "brackets":
            self._inject_brackets(out, rng)
        elif motif == "digits":
            self._inject_digit_runs(out, rng)
        return out

    def _inject_brackets(self, out, rng):
        """Paired open/close tokens at nested offsets (code-like syntax)."""
        open_t, close_t = self.shared_vocab[0], self.shared_vocab[1]
        B, S = out.shape
        for b in range(B):
            n = rng.integers(1, max(2, S // 16))
            for _ in range(n):
                i = rng.integers(0, S - 3)
                j = rng.integers(i + 2, min(S, i + 12))
                out[b, i], out[b, j] = open_t, close_t

    def _inject_digit_runs(self, out, rng):
        digits = self.shared_vocab[2:12]
        B, S = out.shape
        for b in range(B):
            i = rng.integers(0, S - 8)
            run = rng.integers(4, 8)
            out[b, i:i + run] = rng.choice(digits, size=run)

    def sample_mixture(self, weights: dict, batch: int, seq: int,
                       rng: np.random.Generator):
        """Sample a batch from a domain mixture. Returns (tokens, labels)."""
        names = list(weights)
        p = np.array([weights[n] for n in names], float)
        p /= p.sum()
        idx = rng.choice(len(names), size=batch, p=p)
        toks = np.empty((batch, seq), np.int32)
        # vectorized per-domain generation (one chain walk per domain)
        for di, name in enumerate(names):
            rows = np.where(idx == di)[0]
            if len(rows):
                toks[rows] = self.sample_tokens(name, len(rows), seq, rng)
        labels = np.array([DOMAINS.index(names[di]) for di in idx], np.int32)
        return toks, labels
