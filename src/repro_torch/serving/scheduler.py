"""Cross-batch expert-affinity scheduler: the gap between the routing
half (Route -> Cascade) and the execution half (Execute -> Feedback) of
the staged serving pipeline.

The routing stage (``TryageEngine._route_admitted``) scores admitted
requests and tags each with an expert choice; this module owns what
happens next.  Every expert gets one *lane* of pending routed requests,
and a micro-batch is launched only when

  * the lane reaches its bucket ``target`` (a power of two, so the
    flushed micro-batch is a full bucket with zero padded rows), or
  * the lane's oldest request has waited longer than ``max_wait_s``
    (deadline flush — latency wins over occupancy), or
  * the engine is shutting down (drain flush — nothing is left behind).

Because lanes persist across admission batches, same-expert requests
from *different* admission batches coalesce into full buckets instead of
launching as ragged per-batch tails — the continuous-batching behaviour
the FIFO drain in ``TryageEngine.run`` cannot provide.

When a lane is over-full, ``Request.priority`` decides who ships first:
entries are ordered by (priority descending, admission order ascending),
so high-priority requests ride the next flush and equal-priority
requests stay FIFO.

Cascade escalation lanes: requests the routing stage *escalated* (the
router's confidence in its first pick fell below the request's
``min_confidence`` threshold, see ``core.objective.cascade_choice``) are
re-enqueued into a second, per-expert *escalation lane* targeting the
larger expert instead of riding the regular lane.  Escalation lanes
flush under the same target/deadline/drain rules but keep recovered
traffic separate, so tier-0 micro-batches stay full and per-tier
telemetry (``EngineStats``) stays honest.

A port of ``repro.serving.scheduler``: plain host code, the same rules
and names.  Left out until the port has mesh placement: the lanes'
device slots and ``ExpertScheduler.assign_slots``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.serving.requests import Request

# flush reasons recorded in EngineStats.flushes
FLUSH_TARGET = "target"
FLUSH_DEADLINE = "deadline"
FLUSH_DRAIN = "drain"


@dataclasses.dataclass
class LaneEntry:
    """One routed request waiting in an expert lane."""

    req: Request
    pred: np.ndarray          # router's predicted losses row, (M,) f32
    seq: int                  # global admission order, FIFO tiebreak
    cached: bool = False      # routing decision came from the cache
    depth: int = 0            # cascade escalation steps (0 = first pick)
    confidence: float = 1.0   # router confidence in the final expert
    fallback_depth: int = 0   # health-fallback re-selections so far
    spec: bool = False        # provisional: cascade verdict still pending

    @property
    def sort_key(self) -> tuple:
        return (-self.req.priority, self.seq)


class Lane:
    """Pending routed requests for one expert.

    The lane tracks its oldest arrival incrementally: ``push`` is an
    O(1) min-update and ``take`` recomputes the min only over the
    entries it leaves behind.  ``oldest_wait`` is therefore O(1) —
    it runs for every lane on every scheduler tick, and the old
    full-lane ``min()`` re-scan made each tick O(total pending).
    """

    def __init__(self, expert_idx: int):
        self.expert_idx = expert_idx
        self.entries: list[LaneEntry] = []
        self.peak = 0
        self._oldest: float | None = None

    def __len__(self) -> int:
        return len(self.entries)

    def push(self, entry: LaneEntry) -> None:
        self.entries.append(entry)
        self.peak = max(self.peak, len(self.entries))
        a = entry.req.arrival
        if a is not None and (self._oldest is None or a < self._oldest):
            self._oldest = a

    def oldest_wait(self, now: float) -> float:
        if not self.entries or self._oldest is None:
            return 0.0
        return now - self._oldest

    def take(self, n: int | None = None) -> list[LaneEntry]:
        """Remove and return the ``n`` highest-(priority, FIFO) entries;
        ``None`` takes everything."""
        self.entries.sort(key=lambda e: e.sort_key)
        if n is None or n >= len(self.entries):
            out, self.entries = self.entries, []
        else:
            out, self.entries = self.entries[:n], self.entries[n:]
        self._recompute_oldest()
        return out

    def remove(self, uid) -> LaneEntry | None:
        """Remove and return the pending entry for ``uid`` (speculation
        cancel), or None if it already flushed."""
        for j, en in enumerate(self.entries):
            if en.req.uid == uid:
                self.entries.pop(j)
                self._recompute_oldest()
                return en
        return None

    def _recompute_oldest(self) -> None:
        if not self.entries:
            self._oldest = None
            return
        arrivals = [
            e.req.arrival for e in self.entries if e.req.arrival is not None
        ]
        self._oldest = min(arrivals) if arrivals else None


class ExpertScheduler:
    """Lane manager for the expert-executor stage.

    Parameters
    ----------
    n_experts:   library size — one lane per expert index.
    target:      lane occupancy that triggers a full-bucket flush.
                 Power-of-two targets flush with zero padded rows.
    max_wait_s:  deadline for the oldest request in a lane; a lane whose
                 oldest request has waited at least this long flushes on
                 the next tick regardless of occupancy.
    """

    def __init__(self, n_experts: int, target: int, max_wait_s: float):
        assert target >= 1 and max_wait_s >= 0.0
        self.target = target
        self.max_wait_s = max_wait_s
        self.lanes = {i: Lane(i) for i in range(n_experts)}
        # escalation lanes: cascade-recovered traffic, one per expert
        self.esc_lanes = {i: Lane(i) for i in range(n_experts)}
        self._seq = 0
        # per-lane failure injection (tests/benchmarks): outstanding
        # failure count per expert; -1 = fail every flush until cleared
        self._inject_fail: dict[int, int] = {}

    # ------------------------------------------------------- routing in

    def push(
        self,
        expert_idx: int,
        req: Request,
        pred: np.ndarray,
        cached: bool = False,
        depth: int = 0,
        confidence: float = 1.0,
        fallback_depth: int = 0,
        spec: bool = False,
    ) -> None:
        """Enqueue a routed request; escalated requests (``depth > 0``)
        are re-enqueued into the target expert's escalation lane.
        ``spec`` marks the entry provisional — its cascade verdict is
        still in flight and may cancel or confirm it."""
        lanes = self.esc_lanes if depth > 0 else self.lanes
        lanes[expert_idx].push(
            LaneEntry(req, pred, self._seq, cached, depth, confidence,
                      fallback_depth, spec)
        )
        self._seq += 1

    def find_entry(self, expert_idx: int, uid) -> LaneEntry | None:
        """The pending regular-lane entry for ``uid``, or None if it
        already flushed.  Speculative entries always ride regular lanes
        (their provisional depth is 0), so only that tier is searched."""
        for en in self.lanes[expert_idx].entries:
            if en.req.uid == uid:
                return en
        return None

    def remove_entry(self, expert_idx: int, uid) -> LaneEntry | None:
        """Cancel the pending regular-lane entry for ``uid``
        (speculation escalated it elsewhere); None if it already
        flushed."""
        return self.lanes[expert_idx].remove(uid)

    # ------------------------------------------------------ batches out

    def pop_ready(self, now: float) -> Iterator[tuple[int, list[LaneEntry], str]]:
        """Yield ``(expert_idx, entries, reason)`` micro-batches that are
        ready to launch at time ``now``.

        Full lanes flush in exact ``target``-sized buckets (repeatedly,
        if a lane holds several buckets' worth); a deadline flush takes
        the whole lane so no stragglers are left waiting again.
        Escalation lanes follow the same rules after the regular lanes.
        """
        for lane in self._all_lanes():
            while len(lane) >= self.target:
                yield lane.expert_idx, lane.take(self.target), FLUSH_TARGET
            if lane.entries and lane.oldest_wait(now) >= self.max_wait_s:
                yield lane.expert_idx, lane.take(None), FLUSH_DEADLINE

    def drain(self) -> Iterator[tuple[int, list[LaneEntry], str]]:
        """Flush everything still pending — shutdown must leave no
        request behind, in either lane tier.

        Flush labels stay honest at shutdown: a lane holding ``target``
        or more entries ships its full buckets as ``FLUSH_TARGET``
        (they are full buckets — that they flush during drain is an
        accident of timing, not a property of the batch), and only the
        ragged tail is labelled ``FLUSH_DRAIN``.  ``EngineStats.flushes``
        therefore counts exactly the partial micro-batches forced out by
        shutdown, matching docs/METRICS.md."""
        for lane in self._all_lanes():
            while len(lane) >= self.target:
                yield lane.expert_idx, lane.take(self.target), FLUSH_TARGET
            if lane.entries:
                yield lane.expert_idx, lane.take(None), FLUSH_DRAIN

    def _all_lanes(self):
        yield from self.lanes.values()
        yield from self.esc_lanes.values()

    # ------------------------------------------------- failure injection

    def inject_failures(self, expert_idx: int, count: int = -1) -> None:
        """Arm the per-lane failure hook: the next ``count`` flushes of
        this expert's lanes *fail* (``count = -1``: every flush until
        ``clear_failures``).  This is the test/benchmark seam for
        degraded-expert scenarios — the engine consumes one armed
        failure per flush via ``take_failure`` and reacts exactly as it
        would to a real execution error (record it in ``ExpertHealth``,
        re-route the entries through the fallback chain, or fail the
        requests when fallback is off)."""
        self._inject_fail[expert_idx] = count

    def clear_failures(self, expert_idx: int) -> None:
        self._inject_fail.pop(expert_idx, None)

    def take_failure(self, expert_idx: int) -> bool:
        """Consume one armed failure for this expert, if any (called by
        the engine once per flush, before execution)."""
        left = self._inject_fail.get(expert_idx, 0)
        if left == 0:
            return False
        if left > 0:
            left -= 1
            if left == 0:
                self._inject_fail.pop(expert_idx, None)
            else:
                self._inject_fail[expert_idx] = left
        return True

    # -------------------------------------------------------- telemetry

    @property
    def pending(self) -> int:
        return sum(len(lane) for lane in self._all_lanes())

    def occupancy(self) -> dict[int, int]:
        """Current pending depth per expert lane (both tiers pooled)."""
        out = {}
        for lane in self._all_lanes():
            if len(lane):
                out[lane.expert_idx] = out.get(lane.expert_idx, 0) + len(lane)
        return out

    def depths(self) -> list[int]:
        """Current pending depth for *every* expert (both tiers pooled,
        zeros included) — the saturation signal ``ExpertHealth`` folds
        into its per-expert depth EWMA at each admission.  Dense on
        purpose: idle lanes must report 0 so their EWMA decays."""
        out = [0] * len(self.lanes)
        for lane in self._all_lanes():
            out[lane.expert_idx] += len(lane)
        return out

    def saturation(self, expert_idx: int) -> float:
        """Pending depth of one expert's lanes as a multiple of the
        flush target (1.0 = exactly one full bucket waiting)."""
        depth = len(self.lanes[expert_idx]) + len(self.esc_lanes[expert_idx])
        return depth / float(self.target)

    def peaks(self) -> dict[int, int]:
        """Peak pending depth per regular expert lane."""
        return {i: lane.peak for i, lane in self.lanes.items() if lane.peak}

    def esc_peaks(self) -> dict[int, int]:
        """Peak pending depth per escalation lane."""
        return {i: lane.peak for i, lane in self.esc_lanes.items() if lane.peak}
