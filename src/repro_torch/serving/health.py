"""Per-expert health and overload signals for the serving front end.

The routing objective assumes every expert in the library is equally
*servable*; production traffic breaks that assumption constantly — an
expert's deployment fails, its lane backs up behind a slow rollout, a
burst saturates one specialist while the rest idle.  This module is the
serving layer's model of that reality: one ``ExpertState`` per expert,
fed by three observation streams the engine already produces,

  * **lane depth** — pending occupancy of the expert's scheduler lanes,
    observed at every admission (EWMA; the overload signal),
  * **flush latency** — wall time of each executed micro-batch
    (EWMA; exported, and a slow-expert telemetry signal for operators),
  * **failures** — failed lane flushes (injected by tests/benchmarks
    through ``ExpertScheduler.inject_failures``, or real execution
    errors), tracked as an EWMA of the per-flush failure indicator
    (the health signal).

and two derived predicates the Route stage consults:

  ``healthy(i)``     the expert's failure EWMA is below threshold, its
                     circuit-breaker cooldown has expired, and it is not
                     administratively forced down.
  ``overloaded(i)``  the expert's lane-depth EWMA is at or above the
                     overload threshold.

``available(i) = healthy(i) and not overloaded(i)`` is the mask the
fallback chain routes around (``core.objective.fallback_choice``);
degraded mode falls back to the smallest *healthy* expert even when it
is overloaded, because answering slowly beats not answering.

Failure recovery is circuit-breaker shaped: a failure marks the expert
unhealthy for at least ``cooldown_s`` (no new traffic routes there, so
the EWMA cannot decay on its own); once the cooldown expires the expert
is half-open — traffic returns, and either successful flushes decay the
failure EWMA below threshold (closed) or the next failure re-opens the
breaker for another cooldown.

Everything here is host-side bookkeeping — no device state — so the
all-healthy fast path costs one boolean mask read per admission batch.

A port of ``repro.serving.health``: the same signals, thresholds and
names.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class ExpertState:
    """Mutable health record for one expert."""

    depth_ewma: float = 0.0       # smoothed pending-lane occupancy
    latency_ewma_s: float = 0.0   # smoothed flush wall time
    failure_ewma: float = 0.0     # smoothed failure indicator in [0, 1]
    flushes: int = 0              # successful flushes observed
    failures: int = 0             # failed flushes observed
    last_failure: float = -1.0    # engine-clock time of the last failure
    forced_down: bool = False     # administrative kill switch


class ExpertHealth:
    """Health/overload tracker over a library of ``n_experts``.

    Parameters
    ----------
    n_experts:       library size — one ``ExpertState`` per index.
    depth_alpha:     EWMA weight for lane-depth observations.
    latency_alpha:   EWMA weight for flush-latency observations.
    failure_alpha:   EWMA weight for the per-flush failure indicator;
                     0.5 means a single failure immediately trips the
                     default threshold and two clean flushes clear it.
    fail_threshold:  ``failure_ewma`` at or above this is unhealthy.
    overload_depth:  ``depth_ewma`` at or above this is overloaded;
                     size it to a few full buckets of backlog relative
                     to the engine's ``lane_target``.
    cooldown_s:      circuit-breaker hold-down after a failure; the
                     expert stays unhealthy at least this long even if
                     the EWMA would have decayed.
    now_fn:          clock (injectable for deterministic tests; the
                     engine passes its own clock so health time and
                     latency time agree).
    """

    def __init__(self, n_experts: int, depth_alpha: float = 0.3,
                 latency_alpha: float = 0.3, failure_alpha: float = 0.5,
                 fail_threshold: float = 0.5, overload_depth: float = 64.0,
                 cooldown_s: float = 30.0,
                 now_fn: Callable[[], float] = time.monotonic):
        assert n_experts >= 1
        assert 0.0 < depth_alpha <= 1.0 and 0.0 < latency_alpha <= 1.0
        assert 0.0 < failure_alpha <= 1.0 and fail_threshold > 0.0
        self.n_experts = n_experts
        self.depth_alpha = depth_alpha
        self.latency_alpha = latency_alpha
        self.failure_alpha = failure_alpha
        self.fail_threshold = fail_threshold
        self.overload_depth = overload_depth
        self.cooldown_s = cooldown_s
        self._now = now_fn
        self.states = [ExpertState() for _ in range(n_experts)]

    # ------------------------------------------------------ observations

    def observe_lane_depth(self, expert_idx: int, depth: int) -> None:
        """Fold one pending-lane occupancy sample into the depth EWMA
        (the engine reports every expert's depth at each admission, so
        idle lanes decay toward zero instead of freezing at their
        last-busy value)."""
        st = self.states[expert_idx]
        a = self.depth_alpha
        st.depth_ewma = (1.0 - a) * st.depth_ewma + a * float(depth)

    def observe_flush(self, expert_idx: int, latency_s: float,
                      ok: bool = True) -> None:
        """Fold one flush outcome in: wall time into the latency EWMA,
        the success/failure indicator into the failure EWMA."""
        st = self.states[expert_idx]
        if ok:
            a = self.latency_alpha
            st.latency_ewma_s = ((1.0 - a) * st.latency_ewma_s
                                 + a * float(latency_s))
            st.flushes += 1
        else:
            st.failures += 1
            st.last_failure = self._now()
        a = self.failure_alpha
        st.failure_ewma = ((1.0 - a) * st.failure_ewma
                           + a * (0.0 if ok else 1.0))

    def record_failure(self, expert_idx: int) -> None:
        """Shorthand for ``observe_flush(i, 0.0, ok=False)``."""
        self.observe_flush(expert_idx, 0.0, ok=False)

    def force_down(self, expert_idx: int, down: bool = True) -> None:
        """Administrative kill switch (and its release) — operators and
        benchmarks use this to take an expert out of rotation
        unconditionally, independent of the learned signals."""
        self.states[expert_idx].forced_down = down

    # -------------------------------------------------------- predicates

    def healthy(self, expert_idx: int) -> bool:
        st = self.states[expert_idx]
        if st.forced_down:
            return False
        if (st.last_failure >= 0.0
                and self._now() - st.last_failure < self.cooldown_s):
            return False
        return st.failure_ewma < self.fail_threshold

    def overloaded(self, expert_idx: int) -> bool:
        return self.states[expert_idx].depth_ewma >= self.overload_depth

    def available(self, expert_idx: int) -> bool:
        return self.healthy(expert_idx) and not self.overloaded(expert_idx)

    def healthy_mask(self) -> np.ndarray:
        return np.array([self.healthy(i) for i in range(self.n_experts)],
                        bool)

    def available_mask(self) -> np.ndarray:
        return np.array([self.available(i) for i in range(self.n_experts)],
                        bool)

    # -------------------------------------------------------- telemetry

    def snapshot(self) -> list[dict]:
        """Per-expert health telemetry (consumed by ``serving.metrics``
        and ``EngineStats.summary``)."""
        out = []
        for i, st in enumerate(self.states):
            out.append({
                "healthy": self.healthy(i),
                "overloaded": self.overloaded(i),
                "depth_ewma": round(st.depth_ewma, 4),
                "latency_ewma_s": round(st.latency_ewma_s, 6),
                "failure_ewma": round(st.failure_ewma, 4),
                "flushes": st.flushes,
                "failures": st.failures,
                "forced_down": st.forced_down,
            })
        return out
