"""The port's lane scheduler (``repro_torch.serving.scheduler``) against
the JAX package's.

Seeded random op streams go to both ``ExpertScheduler``s: pushes with a
random expert, priority, escalation depth and arrival, clock advances,
``pop_ready``, ``find_entry`` / ``remove_entry``, failure injection and
``drain``.  After every op the yields ``(expert, [uids], reason)`` and
the telemetry (``depths``, ``occupancy``, ``peaks``, ``esc_peaks``,
``saturation``, ``pending``) must be equal.  Then the deterministic
cases of ``tests/test_scheduler.py`` and ``tests/test_speculation.py``
run on the port, with seeded numpy variants of the hypothesis
properties (no hypothesis needed).
"""

import numpy as np
import pytest

from repro_torch.serving import Request
from repro_torch.serving.scheduler import (FLUSH_DEADLINE, FLUSH_DRAIN,
                                           FLUSH_TARGET, ExpertScheduler,
                                           Lane, LaneEntry)


def _req(uid, priority=0, arrival=None, request_cls=Request):
    rng = np.random.default_rng(uid)
    return request_cls(uid=uid, tokens=rng.integers(4, 64, 32).astype(
        np.int32), priority=priority, arrival=arrival)


def _flat(flushes):
    return [(mi, [e.req.uid for e in entries], reason)
            for mi, entries, reason in flushes]


def _telemetry(sched, n):
    return (sched.depths(), sched.occupancy(), sched.peaks(),
            sched.esc_peaks(), [sched.saturation(i) for i in range(n)],
            sched.pending)


# ------------------------------------------------ parity with the JAX one


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_matches_jax_on_random_ops(seed):
    pytest.importorskip("jax")
    from repro.serving import Request as JRequest
    from repro.serving.scheduler import ExpertScheduler as JScheduler

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5))
    target = int(rng.integers(1, 7))
    wait = float(rng.choice([0.0, 0.05, 0.3, 1e9]))
    scheds = (JScheduler(n, target, wait), ExpertScheduler(n, target, wait))
    now, uid, uids = 1.0, 0, []
    for _ in range(160):
        op = rng.choice(["push", "push", "push", "tick", "pop", "find",
                         "remove", "inject", "fail", "clear"])
        outs = []
        if op == "push":
            e, prio = int(rng.integers(n)), int(rng.integers(0, 4))
            depth, arrival = int(rng.integers(0, 3)), now - rng.random() * 0.1
            spec = bool(depth == 0 and rng.random() < 0.3)
            for sched, cls in zip(scheds, (JRequest, Request)):
                sched.push(e, _req(uid, prio, arrival, cls),
                           np.full(n, uid, np.float32), depth=depth,
                           spec=spec)
            uids.append(uid)
            uid += 1
        elif op == "tick":
            now += float(rng.choice([0.01, 0.1, 0.5]))
        elif op == "pop":
            outs = [_flat(s.pop_ready(now)) for s in scheds]
        elif op in ("find", "remove") and uids:
            e, u = int(rng.integers(n)), int(rng.choice(uids))
            fn = "find_entry" if op == "find" else "remove_entry"
            got = [getattr(s, fn)(e, u) for s in scheds]
            outs = [None if g is None else (g.req.uid, g.seq, g.depth, g.spec)
                    for g in got]
        elif op == "inject":
            e, count = int(rng.integers(n)), int(rng.choice([-1, 1, 2]))
            for s in scheds:
                s.inject_failures(e, count)
        elif op == "fail":
            e = int(rng.integers(n))
            outs = [s.take_failure(e) for s in scheds]
        elif op == "clear":
            e = int(rng.integers(n))
            for s in scheds:
                s.clear_failures(e)
        assert outs[1:] == outs[:1], op
        assert _telemetry(scheds[1], n) == _telemetry(scheds[0], n), op
    drained = [_flat(s.drain()) for s in scheds]
    assert drained[1] == drained[0]
    assert _telemetry(scheds[1], n) == _telemetry(scheds[0], n)
    assert scheds[1].pending == 0


# ------------------------------------ tests/test_scheduler.py, on the port


def test_full_lane_flushes_exact_target_bucket():
    sched = ExpertScheduler(n_experts=2, target=4, max_wait_s=100.0)
    for i in range(5):
        sched.push(0, _req(i, arrival=1.0), np.zeros(2))
    ((mi, entries, reason),) = sched.pop_ready(now=1.0)
    assert (mi, reason, len(entries)) == (0, FLUSH_TARGET, 4)
    assert sched.pending == 1


def test_priority_ordering_under_full_lane():
    sched = ExpertScheduler(n_experts=1, target=4, max_wait_s=100.0)
    for i, p in enumerate([0, 5, 1, 0, 3, 0]):
        sched.push(0, _req(i, priority=p, arrival=1.0), np.zeros(2))
    ((_, entries, _),) = sched.pop_ready(now=1.0)
    assert [e.req.uid for e in entries] == [1, 4, 2, 0]
    assert sorted(e.req.uid for e in sched.lanes[0].entries) == [3, 5]


def test_deadline_flush_of_single_request_lane():
    sched = ExpertScheduler(n_experts=2, target=8, max_wait_s=0.5)
    sched.push(1, _req(0, arrival=1.0), np.zeros(2))
    assert list(sched.pop_ready(now=1.2)) == []
    ((mi, entries, reason),) = sched.pop_ready(now=1.6)
    assert (mi, reason, len(entries)) == (1, FLUSH_DEADLINE, 1)
    assert sched.pending == 0


def test_drain_flushes_everything():
    sched = ExpertScheduler(n_experts=3, target=4, max_wait_s=100.0)
    for i in range(7):
        sched.push(i % 3, _req(i, arrival=1.0), np.zeros(2))
    drained = [e.req.uid for _, ents, reason in sched.drain() for e in ents
               if reason == FLUSH_DRAIN]
    assert sorted(drained) == list(range(7))
    assert sched.pending == 0


def test_drain_labels_full_buckets_as_target():
    sched = ExpertScheduler(n_experts=1, target=4, max_wait_s=100.0)
    for i in range(9):
        sched.push(0, _req(i, arrival=1.0), np.zeros(2))
    assert [(len(e), r) for _, e, r in sched.drain()] == [
        (4, FLUSH_TARGET), (4, FLUSH_TARGET), (1, FLUSH_DRAIN)]


def test_drain_exact_target_lane_is_all_target():
    sched = ExpertScheduler(n_experts=2, target=3, max_wait_s=100.0)
    for i in range(3):
        sched.push(1, _req(i, arrival=1.0), np.zeros(2))
    assert [(mi, len(e), r) for mi, e, r in sched.drain()] == [
        (1, 3, FLUSH_TARGET)]


def _op_stream(rng):
    """tests/test_scheduler.py's hypothesis op stream, from numpy."""
    return [("push", int(rng.integers(0, 3)), int(rng.integers(0, 4)))
            if rng.random() < 0.7 else "flush"
            for _ in range(int(rng.integers(1, 49)))]


@pytest.mark.parametrize("seed", range(4))
def test_flushes_never_reorder_same_priority(seed):
    """Seeded variant of the hypothesis property: equal priorities leave
    a lane in admission order, nothing lost or duplicated."""
    rng = np.random.default_rng(seed)
    for _ in range(15):
        sched = ExpertScheduler(3, int(rng.integers(1, 7)), 1e9)
        pushed, emitted = [], []
        for op in _op_stream(rng):
            if op == "flush":
                emitted += [(mi, e) for mi, ents, _ in sched.pop_ready(1.0)
                            for e in ents]
            else:
                _, lane, prio = op
                sched.push(lane, _req(len(pushed), prio, 1.0), np.zeros(3))
                pushed.append(len(pushed))
        emitted += [(mi, e) for mi, ents, _ in sched.drain() for e in ents]
        assert sorted(e.req.uid for _, e in emitted) == pushed
        seen: dict = {}
        for mi, e in emitted:
            key = (mi, e.req.priority)
            assert seen.get(key, -1) < e.seq
            seen[key] = e.seq


@pytest.mark.parametrize("esc", [False, True])
def test_escalation_lanes_share_exactly_once_guarantee(esc):
    rng = np.random.default_rng(int(esc))
    for _ in range(20):
        sched = ExpertScheduler(3, int(rng.integers(1, 5)), 1e9)
        pushed, emitted = [], []
        for op in _op_stream(rng):
            if op == "flush":
                emitted += [e for _, ents, _ in sched.pop_ready(1.0)
                            for e in ents]
            else:
                _, lane, prio = op
                sched.push(lane, _req(len(pushed), prio, 1.0), np.zeros(3),
                           depth=int(esc))
                pushed.append(len(pushed))
        emitted += [e for _, ents, _ in sched.drain() for e in ents]
        assert sorted(e.req.uid for e in emitted) == pushed
        assert all(e.depth == int(esc) for e in emitted)
        if esc and pushed:
            assert sched.esc_peaks() and not sched.peaks()


@pytest.mark.parametrize("seed", range(3))
def test_oldest_wait_matches_naive_rescan(seed):
    rng = np.random.default_rng(seed)
    lane = Lane(0)
    for uid in range(60):
        if rng.random() < 0.6:
            lane.push(LaneEntry(req=_req(uid, arrival=float(
                rng.uniform(0.0, 100.0))), pred=np.zeros(2), seq=uid))
        else:
            lane.take(int(rng.integers(1, 5)))
        arrivals = [e.req.arrival for e in lane.entries]
        naive = (200.0 - min(arrivals)) if arrivals else 0.0
        assert lane.oldest_wait(200.0) == naive


# ---------------------------------- tests/test_speculation.py, on the port


def test_scheduler_remove_entry_recomputes_oldest():
    sched = ExpertScheduler(2, target=8, max_wait_s=1.0)
    pred = np.zeros(2, np.float32)
    sched.push(0, _req(1, arrival=1.0), pred, spec=True)
    sched.push(0, _req(2, arrival=2.0), pred, spec=True)
    sched.push(0, _req(3, arrival=3.0), pred)
    lane = sched.lanes[0]
    assert lane.oldest_wait(5.0) == 4.0
    en = sched.remove_entry(0, 1)
    assert en is not None and en.req.uid == 1 and en.spec
    assert lane.oldest_wait(5.0) == 3.0
    assert sched.remove_entry(0, 99) is None
    assert sched.find_entry(0, 2).spec
    assert sched.remove_entry(0, 2).req.uid == 2
    assert lane.oldest_wait(5.0) == 2.0 and sched.pending == 1
    assert sched.remove_entry(0, 3).req.uid == 3
    assert lane.oldest_wait(5.0) == 0.0 and sched.pending == 0


def test_scheduler_find_entry_searches_regular_lane_only():
    sched = ExpertScheduler(2, target=8, max_wait_s=1.0)
    sched.push(1, _req(7, arrival=1.0), np.zeros(2, np.float32), depth=1)
    assert sched.find_entry(1, 7) is None
    assert sched.remove_entry(1, 7) is None
    assert sched.pending == 1


def test_failure_injection_counts_down():
    sched = ExpertScheduler(2, target=4, max_wait_s=1.0)
    sched.inject_failures(0, 2)
    sched.inject_failures(1)
    assert [sched.take_failure(0) for _ in range(3)] == [True, True, False]
    assert all(sched.take_failure(1) for _ in range(5))
    sched.clear_failures(1)
    assert not sched.take_failure(1)
