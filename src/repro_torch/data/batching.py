"""MLM / CLM batch construction and a deterministic batch iterator
(numpy; a copy of ``repro.data.batching`` so the port never imports the
JAX package).  The numpy generator is consumed in the reference's order,
so the same seed gives the same batches in both packages."""

from __future__ import annotations

import numpy as np

from repro_torch.data.corpus import MASK, DomainCorpus


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


def clm_batch(tokens: np.ndarray):
    return {"tokens": tokens, "mask": np.ones_like(tokens, np.int32)}


class BatchIterator:
    """Deterministic stream of MLM batches from a domain mixture."""

    def __init__(self, corpus: DomainCorpus, weights: dict, batch: int,
                 seq: int, seed: int = 0, mask_rate: float = 0.15):
        self.corpus, self.weights = corpus, weights
        self.batch, self.seq, self.mask_rate = batch, seq, mask_rate
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        toks, labels = self.corpus.sample_mixture(
            self.weights, self.batch, self.seq, self.rng)
        b = mlm_batch(toks, self.rng, self.mask_rate,
                      self.corpus.vocab_size)
        b["domain"] = labels
        return b
