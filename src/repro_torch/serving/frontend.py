"""The serving front end: concurrent client sessions multiplexed into
``TryageEngine.serve()`` through a bounded admission queue.

Until now traffic entered the engine as one in-process iterator — fine
for benchmarks, nothing like an ingress.  This module grows the real
thing in the same single-threaded, generator-driven idiom the engine
already uses:

* A ``Session`` is one client's request stream: any iterable yielding
  ``Request`` objects or ``None`` idle ticks (an arrival simulator whose
  next request is not due yet yields ``None``).  Sessions are polled
  round-robin, one item per session per engine pull, so no client can
  starve the others by producing faster.
* Arrivals land in a bounded **admission queue** (``capacity``).  When
  the queue is full the frontend load-sheds by ``Request.priority``:
  the lowest-priority request — queued or incoming, ties shed the
  newest — is rejected outright and counted in
  ``EngineStats.shed`` / ``shed_by_priority``.  Everything admitted is
  FIFO from there; shedding is the only reordering the queue does.
* The engine consumes the queue through ``ServingFrontend.serve()``,
  which is a drop-in replacement for ``engine.serve(iterator)`` —
  Results stream back exactly as before, and idle ticks propagate so
  the scheduler's deadline flushes keep firing while every session is
  quiet.

Backpressure story: the queue bounds how much admitted-but-unrouted
work can exist, so a burst beyond ``capacity`` costs the *lowest-value*
traffic its admission instead of growing latency without bound for
everyone.  Shed requests never reach the router — they produce no
``Result`` and are listed in ``ServingFrontend.shed_uids`` for the
caller (a real ingress would turn that into an HTTP 429/503).

The frontend is deliberately health-agnostic: overload *inside* the
engine (a saturated expert lane) is the health tracker's job
(``serving.health``), routed around by the fallback stage; overload
*at the door* is the admission queue's job.  The two compose but do not
depend on each other.

A port of ``repro.serving.frontend``: the same shed rule, multiplexing
and counters.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterable, Iterator

from repro_torch.serving.requests import Request, Result

if TYPE_CHECKING:                                      # pragma: no cover
    from repro_torch.serving.engine import TryageEngine


@dataclasses.dataclass
class Session:
    """One client's request stream.

    ``requests`` yields ``Request`` objects (ready to admit now) or
    ``None`` (the session is alive but has nothing due yet — e.g. a
    timed arrival process waiting for its next arrival).  The session
    ends when the iterable is exhausted.
    """

    name: str
    requests: Iterable[Request | None]


class AdmissionQueue:
    """Bounded FIFO with priority-based load-shedding.

    ``offer`` admits a request if there is room; at capacity it sheds
    the lowest-priority request in play — the incoming one if its
    priority is less than or equal to the current minimum (newest sheds
    first on ties), otherwise the oldest queued request at that minimum
    priority (which frees the slot for the higher-priority arrival).
    Returns the shed ``Request`` (``None`` when nothing was shed), so
    the caller owns the rejection accounting.
    """

    def __init__(self, capacity: int):
        assert capacity >= 1
        self.capacity = capacity
        self._items: list[Request] = []
        self.peak = 0

    def __len__(self) -> int:
        return len(self._items)

    def offer(self, req: Request) -> Request | None:
        if len(self._items) < self.capacity:
            self._items.append(req)
            self.peak = max(self.peak, len(self._items))
            return None
        lowest = min(range(len(self._items)),
                     key=lambda i: self._items[i].priority)
        if req.priority <= self._items[lowest].priority:
            return req                       # incoming is the loser
        shed = self._items.pop(lowest)
        self._items.append(req)
        return shed

    def pop(self) -> Request | None:
        return self._items.pop(0) if self._items else None


class ServingFrontend:
    """Multiplex concurrent sessions into one engine.

    Parameters
    ----------
    engine:    the ``TryageEngine`` to feed (its stats pick up the
               frontend counters: sessions, admitted, shed,
               shed_by_priority, admission queue peak).
    sessions:  the client sessions to serve, polled round-robin.
    capacity:  admission-queue bound; arrivals beyond it shed the
               lowest-priority request in play.
    """

    def __init__(self, engine: TryageEngine, sessions: list[Session],
                 capacity: int = 256):
        assert sessions, "frontend needs at least one session"
        self.engine = engine
        self.sessions = sessions
        self.queue = AdmissionQueue(capacity)
        self.shed_uids: list[int] = []
        engine.stats.sessions = len(sessions)

    def _shed(self, req: Request) -> None:
        st = self.engine.stats
        st.shed += 1
        st.shed_by_priority[int(req.priority)] += 1
        self.shed_uids.append(req.uid)

    def _multiplex(self) -> Iterator[Request | None]:
        """Round-robin the sessions into the admission queue and yield
        admitted requests (or idle ticks) to the engine.

        Each engine pull drives one polling sweep: every live session
        contributes at most one item, due arrivals pass through the
        bounded queue (shedding at capacity), and the oldest admitted
        request is yielded.  With nothing admitted this sweep, a
        ``None`` idle tick is yielded instead so the engine's deadline
        flushes fire while all sessions are quiet."""
        st = self.engine.stats
        live = [iter(s.requests) for s in self.sessions]
        while live or len(self.queue):
            for it in list(live):
                try:
                    item = next(it)
                except StopIteration:
                    live.remove(it)
                    continue
                if item is None:
                    continue
                if item.arrival is None:
                    item.arrival = self.engine._now()
                shed = self.queue.offer(item)
                if shed is not None:
                    self._shed(shed)
            st.admission_queue_peak = max(st.admission_queue_peak,
                                          self.queue.peak)
            nxt = self.queue.pop()
            if nxt is not None:
                st.admitted += 1
                yield nxt
            elif live:
                yield None

    def serve(self) -> Iterator[Result]:
        """Stream Results for everything admitted, until every session
        is exhausted and the engine has drained.  Drop-in for
        ``engine.serve(iterator)`` — shed requests simply never appear
        in the output (their uids are in ``shed_uids``)."""
        return self.engine.serve(self._multiplex())
