"""Semantic (approximate) decision-cache tier keyed on router embeddings.

Embedding-space performance prediction implies near-identical prompts
get near-identical verdicts: a paraphrase or lightly-edited retry lands
next to its original in the router's pooled embedding space even though
its token bytes differ, so the exact tiers miss it.  T3 answers such a
miss with the verdict of the *nearest* cached embedding, but only when
it is provably close (squared L2 within a calibrated ``eps``) and only
after revalidation — the stored entry must carry the **live** router
version, and the request's lambda vector and cascade threshold must
match the entry's context exactly (they are part of the context key,
never approximated).  Anything else falls through to a fresh score, so
the version invariant (stale params can never serve a verdict) holds for
the approximate tier by construction.

``ExactNNIndex`` is the compact ANN structure underneath: an IVF-flat
layout (coarse cells around sampled centroids, per-cell radius) whose
query prunes cells with the triangle inequality — a cell is skipped
only when ``dist(q, centroid) - radius`` already exceeds the best
candidate, so the answer is *exactly* the brute-force nearest
neighbour (tests/test_cache_stack.py holds the JAX package's copy to
a NumPy ``argmin`` oracle, tests/test_torch_cache_stack.py this one to
that copy).  Ids are stable: tombstoned slots are reused in place, and
vectors added since the last rebuild sit in a flat pending list that is
always scanned, so pruning stays exact between rebuilds.

A numpy copy of ``repro.serving.semcache``: the index stays on the host,
as in the JAX package; only the embeddings it is fed come from the card.
"""

from __future__ import annotations

import numpy as np


class ExactNNIndex:
    """Exact nearest-neighbour index over float32 vectors.

    ``add`` returns a stable integer slot id; ``query`` returns
    ``(id, squared_distance)`` for an exact nearest live vector (ties
    broken arbitrarily among equals) or ``None`` when empty;
    ``discard`` tombstones an id.  Tombstoned slots are reused by later
    ``add``s, so the footprint is bounded by the peak live count."""

    def __init__(self, dim: int, min_build: int = 64):
        self.dim = int(dim)
        self._data = np.zeros((0, self.dim), np.float32)
        self._dead = np.zeros(0, bool)
        self._free: list[int] = []           # tombstoned slots to reuse
        self._min_build = min_build
        # coarse layer: centroids (K, d), member ids and radius per cell.
        # Cell membership may go stale (discard + slot reuse); stale
        # members are extra work, never wrong answers — a reused slot is
        # also in the pending list, which every query scans.
        self._centroids: np.ndarray | None = None
        self._cells: list[np.ndarray] = []
        self._radii: np.ndarray | None = None
        self._pending: list[int] = []        # ids not yet covered by cells

    def __len__(self) -> int:
        return int((~self._dead).sum())

    def add(self, vec: np.ndarray) -> int:
        v = np.asarray(vec, np.float32).reshape(self.dim)
        if self._free:
            idx = self._free.pop()
            self._data[idx] = v
            self._dead[idx] = False
        else:
            self._data = np.concatenate([self._data, v[None]])
            self._dead = np.concatenate([self._dead, [False]])
            idx = len(self._data) - 1
        self._pending.append(idx)
        built = len(self) - len(self._pending)
        if len(self._pending) >= max(self._min_build, built):
            self._rebuild()
        return idx

    def discard(self, idx: int) -> None:
        if not self._dead[idx]:
            self._dead[idx] = True
            self._free.append(int(idx))

    def _rebuild(self) -> None:
        """Re-cover every live id with ~sqrt(n) cells around
        evenly-spaced sample centroids (deterministic — no RNG, so the
        index is a pure function of the add/discard sequence)."""
        live = np.flatnonzero(~self._dead)
        self._pending = []
        n = len(live)
        if n == 0:
            self._centroids, self._cells, self._radii = None, [], None
            return
        k = max(1, int(np.sqrt(n)))
        self._centroids = self._data[live[:: max(1, n // k)][:k]].copy()
        d2 = (((self._data[live][:, None, :]
                - self._centroids[None, :, :]) ** 2).sum(-1))
        assign = d2.argmin(1)
        self._cells = [live[assign == c]
                       for c in range(len(self._centroids))]
        self._radii = np.array(
            [np.sqrt(d2[assign == c, c].max()) if (assign == c).any()
             else 0.0 for c in range(len(self._centroids))])

    def query(self, vec: np.ndarray) -> tuple[int, float] | None:
        q = np.asarray(vec, np.float32).reshape(self.dim)
        best_id, best_d2 = -1, np.inf

        def scan(ids: np.ndarray) -> None:
            nonlocal best_id, best_d2
            ids = np.asarray(ids, int)
            ids = ids[~self._dead[ids]]
            if not len(ids):
                return
            d2 = ((self._data[ids] - q) ** 2).sum(1)
            j = int(d2.argmin())
            if d2[j] < best_d2:
                best_id, best_d2 = int(ids[j]), float(d2[j])

        # flat pending tail first (recent inserts are the likeliest hits)
        if self._pending:
            scan(np.array(self._pending))
        if self._centroids is not None:
            dc = np.sqrt(((self._centroids - q) ** 2).sum(1))
            lb = np.maximum(0.0, dc - self._radii)
            for c in np.argsort(lb, kind="stable"):
                # cells sorted by lower bound: the first unbeatable one
                # proves every later cell is unbeatable too (exactness)
                if lb[c] ** 2 >= best_d2:
                    break
                scan(self._cells[c])
        return None if best_id < 0 else (best_id, best_d2)


class _Entry:
    __slots__ = ("version", "pred", "choice", "depth", "confidence")

    def __init__(self, version, pred, choice, depth, confidence):
        self.version = int(version)
        stored = np.array(pred, np.float32)
        stored.setflags(write=False)
        self.pred = stored
        self.choice = int(choice)
        self.depth = int(depth)
        self.confidence = float(confidence)


class SemanticCache:
    """T3: verdicts keyed on (context, router embedding), answered by
    exact-NN within ``eps`` and revalidated against the live router
    version.

    The *context* — the request's lambda vector laid out in constraint
    order plus its cascade threshold — is matched exactly (one index
    per context): only the prompt itself is approximate, never the
    knobs that change what the right verdict is.  ``get`` returns
    ``(entry, status)`` with status ``"hit"`` (served), ``"stale"``
    (nearest neighbour was within the bound but carried a superseded
    router version — rejected and tombstoned) or ``"miss"``.
    Capacity-bounded with FIFO eviction across contexts.
    """

    def __init__(self, eps: float, capacity: int = 65536):
        assert eps > 0.0 and capacity >= 1
        self.eps = float(eps)
        self.capacity = int(capacity)
        self._ctx: dict[tuple, tuple[ExactNNIndex, dict[int, _Entry]]] = {}
        self._size = 0
        self._fifo: list[tuple[tuple, int]] = []   # insert order

    def __len__(self) -> int:
        return self._size

    def put(self, emb: np.ndarray, context: tuple, version: int,
            pred: np.ndarray, choice: int, depth: int = 0,
            confidence: float = 1.0) -> None:
        emb = np.asarray(emb, np.float32).ravel()
        index, entries = self._ctx.setdefault(
            context, (ExactNNIndex(emb.shape[0]), {}))
        idx = index.add(emb)
        entries[idx] = _Entry(version, pred, choice, depth, confidence)
        self._fifo.append((context, idx))
        self._size += 1
        while self._size > self.capacity and self._fifo:
            octx, oidx = self._fifo.pop(0)
            oindex, oentries = self._ctx[octx]
            if oentries.pop(oidx, None) is not None:
                oindex.discard(oidx)
                self._size -= 1

    def get(self, emb: np.ndarray, context: tuple, live_version: int,
            ) -> tuple[tuple | None, str]:
        found = self._ctx.get(context)
        if found is None:
            return None, "miss"
        index, entries = found
        near = index.query(np.asarray(emb, np.float32).ravel())
        if near is None or near[1] > self.eps ** 2:
            return None, "miss"
        e = entries[near[0]]
        if e.version != int(live_version):
            # revalidation failed: the verdict was scored by superseded
            # parameters.  Versions only move forward, so the entry can
            # never serve again — tombstone it on the way out.
            entries.pop(near[0])
            index.discard(near[0])
            self._size -= 1
            return None, "stale"
        return (e.pred, e.choice, e.depth, e.confidence), "hit"

    def stale_versions(self, live_version: int) -> set[int]:
        """Router versions carried by live entries, minus the live one
        (same contract as ``DecisionCache.stale_versions``)."""
        versions = {e.version
                    for _, entries in self._ctx.values()
                    for e in entries.values()}
        return versions - {int(live_version)}

    def clear(self) -> None:
        self._ctx.clear()
        self._fifo.clear()
        self._size = 0


def calibrate_eps(embeddings: np.ndarray, verdicts: np.ndarray,
                  margin: float = 0.5) -> float:
    """Distance bound under which nearest-neighbour verdict reuse is
    safe *on the calibration sample*: ``margin`` times the smallest
    distance between any two embeddings whose verdicts differ.  Any two
    prompts closer than the returned eps agreed on their verdict in the
    sample, with a 1/margin safety factor for unseen traffic.  Returns
    ``inf`` when every calibration verdict agrees (no separating pair —
    pick an application bound instead)."""
    emb = np.asarray(embeddings, np.float64)
    v = np.asarray(verdicts).ravel()
    assert len(emb) == len(v)
    best = np.inf
    for i in range(len(emb) - 1):
        diff = v[i + 1:] != v[i]
        if diff.any():
            d = np.sqrt(((emb[i + 1:][diff] - emb[i]) ** 2).sum(1)).min()
            best = min(best, float(d))
    return margin * best
