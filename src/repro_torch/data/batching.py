"""MLM batch construction (numpy; a copy of ``repro.data.batching``'s
``mlm_batch`` so the port never imports the JAX package)."""

from __future__ import annotations

import numpy as np

from repro_torch.data.corpus import MASK


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
