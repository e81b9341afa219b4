"""Router-decision cache: the in-process exact LRU (tier T1) and the
three-tier stack over it (T1 exact LRU, T2 persistent KV, T3 semantic).

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

``DecisionCacheStack`` adds the persistent tier (T2, a Valkey-shaped
``serving.kvstore`` store) and the semantic tier (T3,
``serving.semcache``).  T2 stores keys and verdicts through the codecs
below, whose bytes are those of ``repro.serving.cache``: one store
serves engines of both packages.
"""

from __future__ import annotations

import logging
import struct
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

    def lookup(self, key: tuple) -> tuple[tuple | None, str]:
        """Tier-attributed probe: ``(entry, "t1")`` on a hit, ``(None,
        "")`` on a miss — the uniform surface the Route stage uses so a
        plain cache and a ``DecisionCacheStack`` count tier telemetry
        identically."""
        entry = self.get(key)
        return entry, ("t1" if entry is not None else "")

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


# --------------------------------------------------------------- codecs
#
# Stable binary encodings for the exact key and the verdict, used by the
# persistent T2 tier.  Hand-rolled length-prefixed framing (no pickle):
# the encoding is injective, byte-stable across processes and Python
# versions, and contains nothing executable.


def encode_key(key: tuple) -> bytes:
    """Serialize an exact decision-cache key tuple to stable bytes."""
    tok_bytes, dtype_str, shape, lam, min_conf, version = key
    dt = dtype_str.encode("utf-8")
    out = [struct.pack("<qdH", int(version), float(min_conf), len(lam))]
    out.append(struct.pack(f"<{len(lam)}d", *lam) if lam else b"")
    out.append(struct.pack("<H", len(dt)))
    out.append(dt)
    out.append(struct.pack("<H", len(shape)))
    out.append(struct.pack(f"<{len(shape)}q", *shape) if shape else b"")
    out.append(tok_bytes)
    return b"".join(out)


def encode_verdict(
    pred: np.ndarray, choice: int, depth: int, confidence: float
) -> bytes:
    """Serialize a routing verdict to stable bytes."""
    row = np.asarray(pred, np.float32).ravel()
    return (
        struct.pack("<qqdH", int(choice), int(depth), float(confidence), len(row))
        + row.astype("<f4").tobytes()
    )


def decode_verdict(buf: bytes) -> tuple[np.ndarray, int, int, float]:
    """Inverse of ``encode_verdict``; the returned pred row is frozen
    (read-only) like every cached verdict."""
    choice, depth, confidence, m = struct.unpack_from("<qqdH", buf)
    pred = np.frombuffer(buf, "<f4", count=m, offset=struct.calcsize("<qqdH"))
    pred = pred.astype(np.float32)
    pred.setflags(write=False)
    return pred, int(choice), int(depth), float(confidence)


class DecisionCacheStack:
    """Three-tier decision cache: T1 exact LRU, T2 persistent KV, T3
    semantic.

    Exact probes (``lookup``) walk T1 then T2, promoting a T2 hit into
    T1; the semantic tier is consulted separately (``lookup_semantic``)
    because it needs the request's router embedding, which the Route
    stage only computes for exact misses.  ``put`` writes every enabled
    tier.  The constructor signature is capacity-first and
    kwargs-optional so ``DecisionCacheStack(capacity)`` is a drop-in
    T1-only cache (bit-for-bit the plain ``DecisionCache`` behaviour —
    tests/test_cache_stack.py enforces the parity in the JAX package,
    tests/test_torch_cache_stack.py holds this stack to that one)."""

    key = staticmethod(DecisionCache.key)

    def __init__(self, capacity: int = 4096, kv=None, semantic=None):
        self.t1 = DecisionCache(capacity)
        self.kv = kv
        self.semantic = semantic

    @property
    def capacity(self) -> int:
        return self.t1.capacity

    def __len__(self) -> int:
        return len(self.t1)

    def get(self, key: tuple) -> tuple[np.ndarray, int, int, float] | None:
        return self.lookup(key)[0]

    def lookup(self, key: tuple) -> tuple[tuple | None, str]:
        """Exact-tier probe: ``(entry, tier)`` where tier is ``"t1"``
        or ``"t2"`` on a hit, ``(None, "")`` on a miss.  A T2 hit is
        promoted into T1 so the next probe is in-process."""
        entry = self.t1.get(key)
        if entry is not None:
            return entry, "t1"
        if self.kv is not None:
            buf = self.kv.get(encode_key(key))
            if buf is not None:
                pred, choice, depth, conf = decode_verdict(buf)
                self.t1.put(key, pred, choice, depth, conf)
                return self.t1.get(key), "t2"
        return None, ""

    def lookup_semantic(
        self, emb: np.ndarray, key: tuple, live_version: int
    ) -> tuple[tuple | None, str]:
        """T3 probe for one exact-miss row: nearest cached embedding
        under the same (lambda vector, threshold) context, within the
        calibrated bound, revalidated against ``live_version``.
        Returns ``(entry, status)`` — status ``"hit"``/``"stale"``/
        ``"miss"`` (``"off"`` without a semantic tier)."""
        if self.semantic is None:
            return None, "off"
        return self.semantic.get(emb, (key[3], key[4]), live_version)

    def put(
        self,
        key: tuple,
        pred: np.ndarray,
        choice: int,
        depth: int = 0,
        confidence: float = 1.0,
        emb: np.ndarray | None = None,
    ) -> None:
        self.t1.put(key, pred, choice, depth, confidence)
        if self.kv is not None:
            self.kv.set(
                encode_key(key), encode_verdict(pred, choice, depth, confidence)
            )
        if self.semantic is not None and emb is not None:
            # context = (lambda tuple, threshold); version = key's last
            # element, checked again at every semantic hit
            self.semantic.put(
                emb, (key[3], key[4]), key[-1], pred, choice, depth, confidence
            )

    def stale_versions(self, live_version: int) -> set[int]:
        """Stale router versions reachable by the *serving* tiers (T1 +
        T3).  T2 is exempt: its records are keyed by serialized version
        and can only be read back under the exact version that wrote
        them, so old-version records are unreachable here yet still
        valid for a peer/restarted replica at that version."""
        stale = self.t1.stale_versions(live_version)
        if self.semantic is not None:
            stale |= self.semantic.stale_versions(live_version)
        return stale

    def clear(self) -> None:
        """Drop the in-memory tiers (T1 + T3).  T2 survives — see
        ``stale_versions`` for why that is correct."""
        self.t1.clear()
        if self.semantic is not None:
            self.semantic.clear()

    def flush(self) -> None:
        """Durability point for the persistent tier (no-op without T2)."""
        if self.kv is not None:
            self.kv.flush()

    def close(self) -> None:
        if self.kv is not None:
            self.kv.close()
