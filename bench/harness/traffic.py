"""The benchmark's one traffic generator.  A traffic mix is a JSON file
of parameters under ``bench/traffic/``; ``kind`` says which stream it
describes, and the same seed gives the same stream.

``prompts`` (a served library, one request at a time from a closed
loop): masked prompts drawn from the synthetic corpus (``corpus``),
each a row of a pool made in set-up (``domains`` holds each row's
domain).  Every request's own id is written into the ``stamp_tokens``
tokens after the first, so that no two requests share a prompt.  Flags
cycle through ``flags`` by request id (the serving CLI's four-flag
mix).  The domains are uniform and balanced: every aligned run of
domains x flags requests holds each (domain, flags) pair once, so every
seed offers the same work in another order.

``prefill`` and ``decode`` (a served language model): prompts of
``prompt_len`` ids drawn uniformly from the vocabulary, by request
index (``token_prompt``).
"""

from __future__ import annotations

import numpy as np

from harness.corpus import DOMAINS, N_SPECIAL, DomainCorpus, mlm_batch
from harness.weights import derive


def stamp(tokens: np.ndarray, value: int, width: int, vocab: int) -> None:
    """Write ``value`` into ``tokens[1:1 + width]`` as digits of base
    ``vocab - N_SPECIAL`` over the ordinary ids."""
    base = vocab - N_SPECIAL
    for j in range(width):
        value, digit = divmod(value, base)
        tokens[1 + j] = N_SPECIAL + digit
    if value:
        raise ValueError(f"stamp: id too large for {width} tokens")


class Prompts:
    """Requests ``(tokens, targets, mask, lambdas)`` by request id."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        if mix["kind"] != "prompts":
            raise ValueError(f"a served library reads prompts, not "
                             f"{mix['kind']!r}")
        self.mix = mix
        self.vocab = vocab
        self.flags = [dict(f) for f in mix["flags"]]
        corpus = DomainCorpus(vocab_size=vocab, seed=mix["corpus_seed"])
        rng = np.random.default_rng(derive(seed, "pool"))
        P, S, D, F = mix["pool"], mix["prompt_len"], len(DOMAINS), len(
            self.flags)
        if P % (D * F):
            raise ValueError(f"pool {P} is no multiple of {D} domains x "
                             f"{F} flags")
        # request uid serves row uid % P with flags uid % F, so row i
        # always carries flags i % F; in each block of D x F rows the D
        # rows of each flag take the domains in a seeded order
        dom = np.empty(P, np.int64)
        for b in range(0, P, D * F):
            for f in range(F):
                dom[b + f:b + D * F:F] = rng.permutation(D)
        toks = np.empty((P, S), np.int32)
        for d, name in enumerate(DOMAINS):
            rows = np.flatnonzero(dom == d)
            toks[rows] = corpus.sample_tokens(name, len(rows), S, rng)
        self.domains = dom
        mb = mlm_batch(toks, rng, mix["mask_rate"], vocab)
        self.tokens, self.targets = mb["tokens"], mb["targets"]
        self.mask = mb["mask"]
        self.mask[:, 1:1 + mix["stamp_tokens"]] = 0

    def request(self, uid: int):
        """(tokens, targets, mask, lambdas) of request ``uid``."""
        i, width = uid % len(self.tokens), self.mix["stamp_tokens"]
        tokens = self.tokens[i].copy()
        targets = self.targets[i].copy()
        stamp(tokens, uid, width, self.vocab)
        targets[1:1 + width] = tokens[1:1 + width]
        return tokens, targets, self.mask[i], self.flags[uid % len(self.flags)]


def token_prompt(mix: dict, vocab: int, seed: int, index: int,
                 rows: int = 1) -> np.ndarray:
    """Prompt ``index`` of a ``tokens`` mix: (rows, prompt_len) ids."""
    rng = np.random.default_rng(derive(seed, f"prompt:{index}"))
    return rng.integers(0, vocab, (rows, mix["prompt_len"]), dtype=np.int64)
