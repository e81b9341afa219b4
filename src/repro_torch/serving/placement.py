"""Expert -> mesh-slice placement for the sharded Execute stage.

The serving mesh is logically ``(data, model)``: the ``data`` axis
shards the routing stage's admission batches, and the ``model`` axis is
carved into *slices* — one column of devices per slice — that the
Execute stage spreads the expert library over.  A lane flush then runs
on a device owned by its expert's slice instead of serializing every
expert onto device 0, so micro-batches for different experts overlap
in per-device streams.

Two placement rules, both host-side and deterministic:

* **Greedy size-balanced assignment** (LPT): experts are sorted by
  *load* — parameter count times an optional expected traffic share —
  and each is assigned to the currently least-loaded slice.  With
  uniform traffic this balances resident bytes; with a traffic prior
  (benchmarks pre-scan their workload) it balances expected compute.
* **Hot-expert replication**: the ``replicate_hot`` highest-load
  experts are additionally replicated onto *every* slice.  Replicas
  only make sense for experts whose traffic dominates (the flush
  dispatcher picks the least-busy replica stream at flush time), and
  the smallest/hottest experts are exactly the ones a Tryage router
  concentrates traffic on, so replicating them is cheap in bytes and
  large in tail throughput.

Everything here is plain Python, so the scheduler, tests and docs
tooling can reason about placement without touching device state.  The
engine owns the actual ``torch.device`` handles; this module only speaks
slice indices.

A port of ``repro.serving.placement``: the same rules, tie orders,
asserts and ``summary()`` dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """Immutable expert -> slice assignment.

    ``slices[i]`` is the tuple of slice indices expert ``i`` may execute
    on (its *home* slice first, replicas after).  ``n_slices`` is the
    mesh's ``model``-axis extent.
    """

    n_slices: int
    slices: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        assert self.n_slices >= 1
        for s in self.slices:
            assert s, "every expert needs at least one slice"
            assert all(0 <= k < self.n_slices for k in s)
            assert len(set(s)) == len(s), "duplicate replica slice"

    @property
    def n_experts(self) -> int:
        return len(self.slices)

    def home(self, expert_idx: int) -> int:
        """The expert's primary slice (LPT assignment)."""
        return self.slices[expert_idx][0]

    def slices_for(self, expert_idx: int) -> tuple[int, ...]:
        """All slices holding a replica of this expert."""
        return self.slices[expert_idx]

    def replicated(self, expert_idx: int) -> bool:
        return len(self.slices[expert_idx]) > 1

    def summary(self, names: Sequence[str] | None = None) -> dict:
        """Telemetry view: per-slice expert lists plus the replica set
        (the ``launch.serve`` summary's ``"mesh"`` block)."""
        label = (names if names is not None
                 else [str(i) for i in range(self.n_experts)])
        per_slice: list[list[str]] = [[] for _ in range(self.n_slices)]
        for i, ss in enumerate(self.slices):
            for k in ss:
                per_slice[k].append(label[i])
        return {
            "n_slices": self.n_slices,
            "per_slice": {k: members for k, members in
                          enumerate(per_slice)},
            "replicated": [label[i] for i in range(self.n_experts)
                           if self.replicated(i)],
        }


def plan_placement(sizes: Sequence[float], n_slices: int,
                   replicate_hot: int = 0,
                   traffic: Sequence[float] | None = None) -> PlacementMap:
    """Greedy size-balanced (LPT) expert -> slice assignment.

    Parameters
    ----------
    sizes:         per-expert cost proxy (parameter count); must be
                   positive.
    n_slices:      number of mesh slices (``model``-axis extent).
    replicate_hot: replicate the top-K experts by load onto every
                   slice (0 disables replication).
    traffic:       optional expected traffic share per expert; load is
                   ``sizes[i] * traffic[i]`` when given, ``sizes[i]``
                   otherwise.

    The assignment is deterministic: ties in load break on expert index,
    ties in slice occupancy break on slice index, so a given library
    always lands the same way and parity tests can pin expectations.
    """
    n = len(sizes)
    assert n >= 1 and n_slices >= 1
    assert all(s > 0 for s in sizes), "expert sizes must be positive"
    if traffic is not None:
        assert len(traffic) == n
        assert all(t >= 0 for t in traffic)
        load = [float(sizes[i]) * (float(traffic[i]) or 1e-9)
                for i in range(n)]
    else:
        load = [float(s) for s in sizes]
    # LPT: heaviest expert first onto the least-loaded slice
    order = sorted(range(n), key=lambda i: (-load[i], i))
    slice_load = [0.0] * n_slices
    homes = [0] * n
    for i in order:
        k = min(range(n_slices), key=lambda s: (slice_load[s], s))
        homes[i] = k
        slice_load[k] += load[i]
    hot = set(sorted(range(n), key=lambda i: (-load[i], i))
              [:max(0, replicate_hot)]) if n_slices > 1 else set()
    slices = []
    for i in range(n):
        if i in hot:
            rest = [k for k in range(n_slices) if k != homes[i]]
            slices.append((homes[i], *rest))
        else:
            slices.append((homes[i],))
    return PlacementMap(n_slices, tuple(slices))


class StreamClock:
    """Busy-time bookkeeping for per-device execution streams.

    The engine runs its flushes one after another and blocks on each, but
    flushes dispatched to *different* devices are independent programs
    that a multi-device runtime would overlap.  The engine therefore
    attributes each flush's measured wall time to its device's stream;
    the *simulated* makespan of a run is the busiest stream's total, the
    overlapped time such a runtime would take.
    """

    def __init__(self, n_streams: int):
        assert n_streams >= 1
        self.n_streams = n_streams
        self.busy_s = [0.0] * n_streams
        self.flushes = [0] * n_streams
        self.tokens = [0] * n_streams
        self.failures = [0] * n_streams

    def least_busy(self, candidates: Sequence[int]) -> int:
        """The least-loaded stream among ``candidates`` (tie -> lowest
        index) — the replica dispatch rule."""
        return min(candidates, key=lambda d: (self.busy_s[d], d))

    def record(self, stream: int, wall_s: float, tokens: int) -> None:
        self.busy_s[stream] += max(float(wall_s), 0.0)
        self.flushes[stream] += 1
        self.tokens[stream] += int(tokens)

    def reset(self) -> None:
        """Zero all counters (a benchmark resets after its warm pass so
        first-call time never counts as stream busy time)."""
        self.busy_s = [0.0] * self.n_streams
        self.flushes = [0] * self.n_streams
        self.tokens = [0] * self.n_streams
        self.failures = [0] * self.n_streams

    def record_failure(self, stream: int) -> None:
        """A flush failed before executing: no busy time, but the
        per-device view should show which stream lost the work."""
        self.failures[stream] += 1

    @property
    def makespan_s(self) -> float:
        """Simulated overlapped wall time: the busiest stream."""
        return max(self.busy_s)

    @property
    def total_busy_s(self) -> float:
        """Serialized wall time: every stream's busy time summed."""
        return sum(self.busy_s)

    def summary(self) -> dict:
        return {
            "streams": self.n_streams,
            "busy_s": [round(b, 6) for b in self.busy_s],
            "flushes": list(self.flushes),
            "tokens": list(self.tokens),
            "failures": list(self.failures),
            "makespan_s": round(self.makespan_s, 6),
            "total_busy_s": round(self.total_busy_s, 6),
        }
