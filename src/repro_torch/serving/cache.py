"""Router-decision cache, tier T1: the in-process exact LRU.

Scoring is cheap per request but it is pure overhead when the same
prompt arrives again with the same constraint weights — a common shape
of production traffic (retries, template prompts, polling agents).
``DecisionCache`` keys on the exact token bytes plus the request's
lambda vector (in engine constraint order), the cascade threshold and
the router version, so a hit is guaranteed to return the identical
post-cascade verdict the fresh score produced: no hash collisions, no
approximate matching.  The key bytes are those of the JAX package's
``repro.serving.cache.DecisionCache``, so both engines agree on what
counts as the same request.

Capacity-bounded LRU: reads refresh recency, inserts evict the least
recently used entry.  Hit/miss telemetry lives in ``EngineStats``, not
here — the engine is the only consumer.
"""

from __future__ import annotations

import logging
from collections import OrderedDict

import numpy as np

log = logging.getLogger(__name__)

# log-once registry for unknown constraint-flag spellings (module level
# so every cache instance shares it; tests reset it explicitly)
_warned_lambda_names: set[str] = set()


class DecisionCache:
    """LRU cache from (token bytes, lambda vector, confidence threshold)
    to the cascade's final routing verdict."""

    def __init__(self, capacity: int = 4096):
        assert capacity >= 1
        self.capacity = capacity
        self._entries: OrderedDict[tuple, tuple[np.ndarray, int, int, float]] = (
            OrderedDict()
        )

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def key(
        tokens: np.ndarray,
        lambdas: dict,
        constraint_names: list,
        min_confidence: float = 0.0,
        router_version: int = 0,
        unknown_sink=None,
    ) -> tuple:
        """Exact cache key: token buffer bytes (plus dtype/shape, so
        equal byte strings from different layouts cannot collide) + the
        lambda vector laid out in engine constraint order (unknown
        constraint names are ignored, matching ``lambda_matrix``) + the
        request's cascade threshold + the router version that scored the
        entry.  The threshold is part of the key because the cached
        verdict is *post-cascade*: the same prompt at a stricter
        threshold may legitimately escalate to a different expert, and
        cached verdicts must stay exact.  The version is part of the key
        because online adaptation swaps the router parameters
        mid-stream: a verdict scored by version ``v`` must never be
        returned once version ``v + 1`` is live.

        Lambda entries whose names are unknown to the engine's
        constraints cannot affect the verdict (``lambda_matrix`` drops
        them too), so they are dropped from the key — but never
        silently: each dropped name is warned once per process, and
        ``unknown_sink`` (when given) receives the list of dropped
        names so the engine can count them (the
        ``cache_key_dropped_lambda`` stat).  Without the observability,
        two requests with different misspelled flags collide onto one
        verdict and the typo is invisible."""
        unknown = [n for n in lambdas if n not in constraint_names]
        if unknown:
            if unknown_sink is not None:
                unknown_sink(unknown)
            for n in unknown:
                if n not in _warned_lambda_names:
                    _warned_lambda_names.add(n)
                    log.warning(
                        "decision-cache key: lambda flag %r does not match "
                        "any engine constraint %r — dropped (check the "
                        "flag spelling); further drops of this name are "
                        "counted but not logged",
                        n,
                        list(constraint_names),
                    )
        lam = tuple(float(lambdas.get(name, 0.0)) for name in constraint_names)
        return (
            tokens.tobytes(),
            tokens.dtype.str,
            tokens.shape,
            lam,
            float(min_confidence),
            int(router_version),
        )

    def get(self, key: tuple) -> tuple[np.ndarray, int, int, float] | None:
        """Return the memoised verdict (refreshing LRU recency) or None.

        The ``pred`` row is the stored array itself — read-only by
        construction (see ``put``), so sharing it is safe."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        self._entries.move_to_end(key)
        return entry

    def put(
        self,
        key: tuple,
        pred: np.ndarray,
        choice: int,
        depth: int = 0,
        confidence: float = 1.0,
    ) -> None:
        # the stored pred row is handed back by reference on every hit;
        # freeze it so a caller mutating a hit raises instead of silently
        # corrupting all future hits for this key
        stored = np.array(pred, np.float32)
        stored.setflags(write=False)
        self._entries[key] = (
            stored,
            int(choice),
            int(depth),
            float(confidence),
        )
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def stale_versions(self, live_version: int) -> set[int]:
        """Router versions present in stored keys that differ from the
        live one (the version is the key's last element).  Empty means
        the engine's post-swap invariant holds — every surviving entry
        was scored by the live snapshot."""
        return {k[-1] for k in self._entries} - {int(live_version)}

    def clear(self) -> None:
        """Drop every entry (memory reclaim after a router-version bump;
        the version in the key already guarantees stale entries cannot
        hit)."""
        self._entries.clear()
