"""The port's session front end (``repro_torch.serving.frontend``)
against the JAX package's.

Several sessions with mixed priorities and idle ticks go through both
``ServingFrontend``s with a small admission queue: the same requests
are shed (``shed_uids``), the counters (``shed``, ``shed_by_priority``,
``admitted``, ``admission_queue_peak``, ``sessions``) are equal, and
the Results come back in the same order (``torch_serving_util`` states
what is exact and what is held to 1e-5).  Then the admission queue's
deterministic cases of ``tests/test_frontend.py`` run on the port.
"""

import numpy as np
import pytest

from repro_torch.serving import AdmissionQueue, ServingFrontend, Session
from repro_torch.serving import Request as TRequest
from torch_serving_util import (JRequest, assert_same_results,
                                assert_same_stats, make_engines,
                                make_weights, requests, workload)

from repro.serving import ServingFrontend as JFrontend
from repro.serving import Session as JSession


@pytest.fixture(scope="module")
def weights(tiny_library):
    return make_weights(tiny_library)


def _sessions(session_cls, request_cls, work, n_sessions, idle_every):
    """Request i goes to session i % n_sessions with priority i % 3;
    each session yields an idle tick after every ``idle_every`` items."""
    out = []
    for s in range(n_sessions):
        items = []
        for j, w in enumerate(work[s::n_sessions]):
            items.append(request_cls(**w, priority=w["uid"] % 3))
            if idle_every and j % idle_every == idle_every - 1:
                items.append(None)
        out.append(session_cls(f"s{s}", items))
    return out


@pytest.mark.parametrize("n_sessions,capacity,idle_every,max_wait_s", [
    (4, 6, 0, 10.0), (3, 4, 2, 0.0), (5, 256, 3, 10.0)],
    ids=["burst", "idle_ticks", "ample"])
def test_frontend_matches_jax(tiny_library, weights, n_sessions, capacity,
                              idle_every, max_wait_s):
    jeng, teng = make_engines(tiny_library, weights, max_wait_s=max_wait_s,
                              fused_cascade=True)
    work = workload(cascade=True)[:160]
    fronts = (JFrontend(jeng, _sessions(JSession, JRequest, work,
                                        n_sessions, idle_every), capacity),
              ServingFrontend(teng, _sessions(Session, TRequest, work,
                                              n_sessions, idle_every),
                              capacity))
    ref, got = (list(fe.serve()) for fe in fronts)
    assert fronts[1].shed_uids == fronts[0].shed_uids
    assert_same_results(ref, got)
    assert_same_stats(jeng, teng)
    st = teng.stats
    assert st.sessions == n_sessions
    assert sorted([r.uid for r in got] + fronts[1].shed_uids) == list(
        range(160))
    assert st.admitted == len(got) and st.shed == len(fronts[1].shed_uids)
    if capacity < 256:
        assert st.shed > 0 and st.admission_queue_peak == capacity
    else:
        assert st.shed == 0


# ----------------------- tests/test_frontend.py's queue cases, on the port


def _stub(uid, priority):
    z = np.zeros(0, np.int32)
    return TRequest(uid=uid, tokens=z, targets=z, mask=np.zeros(0, bool),
                    priority=priority)


def test_queue_admits_fifo_under_capacity():
    q = AdmissionQueue(4)
    for i in range(4):
        assert q.offer(_stub(i, priority=i)) is None
    assert len(q) == 4 and q.peak == 4
    assert [q.pop().uid for _ in range(4)] == [0, 1, 2, 3]
    assert q.pop() is None


def test_queue_sheds_incoming_on_tie_or_lower_priority():
    q = AdmissionQueue(2)
    q.offer(_stub(0, 1))
    q.offer(_stub(1, 1))
    assert q.offer(_stub(2, 1)).uid == 2
    assert q.offer(_stub(3, 0)).uid == 3
    assert [q.pop().uid, q.pop().uid] == [0, 1]


def test_queue_evicts_oldest_lowest_priority_for_higher():
    q = AdmissionQueue(3)
    q.offer(_stub(0, 1))
    q.offer(_stub(1, 0))
    q.offer(_stub(2, 0))
    assert q.offer(_stub(3, 2)).uid == 1
    assert [q.pop().uid for _ in range(3)] == [0, 2, 3]
    with pytest.raises(AssertionError):
        AdmissionQueue(0)


def test_frontend_round_robin_and_idle_ticks(tiny_library, weights):
    _, teng = make_engines(tiny_library, weights)
    reqs = requests(TRequest, workload()[:6])
    fe = ServingFrontend(teng, [Session("a", [None] + reqs[0:3]),
                                Session("b", reqs[3:6])], capacity=16)
    out = list(fe._multiplex())
    assert [r.uid for r in out if r is not None] == [3, 0, 4, 1, 5, 2]
    assert teng.stats.admitted == 6 and teng.stats.sessions == 2
    assert all(r.arrival == teng._now() for r in out if r is not None)
