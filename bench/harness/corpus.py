"""Synthetic multi-domain corpus, the offline stand-in for the Pile: a
frozen copy of the port's ``data/corpus.py`` and of ``mlm_batch`` from
``data/batching.py``, so that a change to the program cannot change the
benchmark's prompts.  The transition tables are drawn in one call a
domain rather than one a token (a vocabulary of tens of thousands is
built in well under a second), so the draws differ from the port's;
the same seed gives the same tokens.

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
            n_priv = max(1, int(round(branch * priv_w)))
            succ = np.concatenate(
                [drng.choice(self.private_vocab[d], size=(V, n_priv)),
                 drng.choice(self.shared_vocab, size=(V, branch - n_priv))],
                axis=1).astype(np.int32)
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


def mlm_batch(tokens: np.ndarray, rng: np.random.Generator,
              mask_rate: float = 0.15, vocab_size: int = 512):
    """BERT-style masking: 80% [MASK], 10% random, 10% keep."""
    B, S = tokens.shape
    mask = rng.random((B, S)) < mask_rate
    # never mask position 0 so there's always context
    mask[:, 0] = False
    inputs = tokens.copy()
    r = rng.random((B, S))
    use_mask = mask & (r < 0.8)
    use_rand = mask & (r >= 0.8) & (r < 0.9)
    inputs[use_mask] = MASK
    inputs[use_rand] = rng.integers(4, vocab_size,
                                    size=int(use_rand.sum()))
    return {"tokens": inputs, "targets": tokens,
            "mask": mask.astype(np.int32)}
