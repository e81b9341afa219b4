"""The port's placement rules (``repro_torch.serving.placement``) and
lane slots (``ExpertScheduler.assign_slots``) against the JAX package's.

* ``plan_placement`` on drawn expert sizes, slice counts,
  ``replicate_hot`` and traffic priors gives the reference's ``slices``
  and ``summary()`` exactly (both are host code: no tolerance);
* ``StreamClock`` over a drawn sequence of ``record`` /
  ``record_failure`` / ``least_busy`` / ``reset`` calls answers every
  ``least_busy`` alike and ends with the same ``summary()``;
* ``PlacementMap`` and ``plan_placement`` refuse what the reference
  refuses, with the same exception;
* ``assign_slots`` pins both lane tiers to each expert's home slice.
"""

import pytest

from hyputil import given, settings, st
from repro_torch.serving import placement as tpl
from repro_torch.serving.scheduler import ExpertScheduler as TScheduler

pytest.importorskip("jax")

from repro.serving import placement as jpl  # noqa: E402
from repro.serving.scheduler import ExpertScheduler as JScheduler  # noqa: E402


def test_plan_placement_is_lpt_balanced_and_deterministic():
    sizes = [8.0, 7.0, 3.0, 2.0, 1.0, 1.0]
    pm = tpl.plan_placement(sizes, n_slices=2)
    # LPT walk: 8->s0, 7->s1, 3->s1, 2->s0, 1->s0 (tie, low index), 1->s1
    assert [pm.home(i) for i in range(6)] == [0, 1, 1, 0, 0, 1]
    assert pm.slices == jpl.plan_placement(sizes, n_slices=2).slices
    assert pm == tpl.plan_placement(sizes, n_slices=2)
    assert not any(pm.replicated(i) for i in range(6))


def test_plan_placement_replicates_hot_experts_home_first():
    pm = tpl.plan_placement([5.0, 4.0, 1.0], n_slices=3, replicate_hot=2)
    for i in (0, 1):
        ss = pm.slices_for(i)
        assert pm.replicated(i)
        assert ss[0] == pm.home(i) and sorted(ss) == [0, 1, 2]
    assert pm.slices_for(2) == (pm.home(2),)
    # one slice never replicates
    assert tpl.plan_placement([5.0, 4.0, 1.0], 1, 2).slices == (
        (0,), (0,), (0,))


@given(sizes=st.lists(st.floats(0.5, 1e9, allow_nan=False), min_size=1,
                      max_size=12),
       n_slices=st.integers(1, 6), replicate_hot=st.integers(-1, 5),
       traffic=st.one_of(st.none(), st.lists(st.floats(0.0, 1.0),
                                             min_size=12, max_size=12)),
       ties=st.booleans())
@settings(max_examples=200, deadline=None)
def test_plan_placement_matches_jax(sizes, n_slices, replicate_hot, traffic,
                                    ties):
    if ties:                      # whole sizes: load ties break on index
        sizes = [float(round(s) % 4 + 1) for s in sizes]
    if traffic is not None:
        traffic = traffic[:len(sizes)]
    names = [f"e{i}" for i in range(len(sizes))]
    ref = jpl.plan_placement(sizes, n_slices, replicate_hot, traffic)
    got = tpl.plan_placement(sizes, n_slices, replicate_hot, traffic)
    assert got.slices == ref.slices
    assert got.n_slices == ref.n_slices == n_slices
    assert got.summary(names) == ref.summary(names)
    assert got.summary() == ref.summary()
    for i in range(len(sizes)):
        assert (got.home(i), got.replicated(i)) == (ref.home(i),
                                                    ref.replicated(i))


_clock_ops = st.lists(st.one_of(
    st.tuples(st.just("record"), st.integers(0, 4),
              st.floats(-1.0, 5.0, allow_nan=False), st.integers(0, 512)),
    st.tuples(st.just("record_failure"), st.integers(0, 4)),
    st.tuples(st.just("least_busy"),
              st.lists(st.integers(0, 4), min_size=1, max_size=5)),
    st.tuples(st.just("reset"))), max_size=40)


@given(n_streams=st.integers(1, 5), ops=_clock_ops)
@settings(max_examples=200, deadline=None)
def test_stream_clock_matches_jax(n_streams, ops):
    ref, got = jpl.StreamClock(n_streams), tpl.StreamClock(n_streams)
    for op, *args in ops:
        if op != "reset" and op != "least_busy" and args[0] >= n_streams:
            continue
        if op == "least_busy":
            args = [[d for d in args[0] if d < n_streams] or [0]]
        a, b = getattr(ref, op)(*args), getattr(got, op)(*args)
        assert b == a, (op, args)
        assert got.summary() == ref.summary()
        assert (got.makespan_s, got.total_busy_s) == (ref.makespan_s,
                                                      ref.total_busy_s)


def test_stream_clock_accounting_and_dispatch():
    sc = tpl.StreamClock(3)
    sc.record(0, 2.0, tokens=100)
    sc.record(2, 0.5, tokens=10)
    assert sc.least_busy([0, 2]) == 2
    assert sc.least_busy([1, 2]) == 1
    sc.record(1, 0.5, tokens=10)
    sc.record(1, -3.0, tokens=1)               # negative time counts 0
    assert sc.makespan_s == 2.0 and sc.total_busy_s == 3.0
    sc.record_failure(2)
    s = sc.summary()
    assert s["flushes"] == [1, 2, 1] and s["failures"] == [0, 0, 1]
    assert s["tokens"] == [100, 11, 10]
    sc.reset()
    assert sc.makespan_s == 0.0 and sc.summary()["flushes"] == [0, 0, 0]


REFUSALS = [
    ("plan", ([1.0, 0.0], 2), {}),                     # non-positive size
    ("plan", ([1.0], 2), {"traffic": [0.5, 0.5]}),     # traffic length
    ("plan", ([1.0, 2.0], 2), {"traffic": [0.5, -1]}),  # negative traffic
    ("plan", ([], 2), {}),                             # no expert
    ("plan", ([1.0], 0), {}),                          # no slice
    ("map", (2, ((0,), (2,))), {}),                    # slice out of range
    ("map", (2, ((0, 0),)), {}),                       # duplicate replica
    ("map", (2, ((0,), ())), {}),                      # expert with no slice
    ("map", (0, ()), {}),                              # no slice
    ("clock", (0,), {}),                               # no stream
]


@pytest.mark.parametrize("kind,args,kwargs", REFUSALS,
                         ids=[f"{k}{i}" for i, (k, _, _) in
                              enumerate(REFUSALS)])
def test_refusals_match_jax(kind, args, kwargs):
    for mod in (jpl, tpl):
        fn = {"plan": mod.plan_placement, "map": mod.PlacementMap,
              "clock": mod.StreamClock}[kind]
        with pytest.raises(AssertionError):
            fn(*args, **kwargs)


def test_scheduler_assigns_lane_slots_from_placement():
    pm = tpl.plan_placement([3.0, 2.0, 1.0, 5.0], n_slices=2,
                            replicate_hot=1)
    jpm = jpl.plan_placement([3.0, 2.0, 1.0, 5.0], n_slices=2,
                             replicate_hot=1)
    tsched = TScheduler(n_experts=4, target=4, max_wait_s=1.0)
    jsched = JScheduler(n_experts=4, target=4, max_wait_s=1.0)
    assert all(lane.slot is None for lane in tsched.lanes.values())
    assert all(lane.slot is None for lane in tsched.esc_lanes.values())
    tsched.assign_slots(pm)
    jsched.assign_slots(jpm)
    for i in range(4):
        assert tsched.lanes[i].slot == tsched.esc_lanes[i].slot == pm.home(i)
        assert tsched.lanes[i].slot == jsched.lanes[i].slot
        assert tsched.esc_lanes[i].slot == jsched.esc_lanes[i].slot
    # the slot changes no health signal: depths stay per expert
    assert tsched.depths() == jsched.depths() == [0, 0, 0, 0]
