"""The port's expert health (``repro_torch.serving.health``), its
Fallback stage and ``serve()``'s failed-flush path against the JAX
package's.

* The same seeded observation stream goes to both ``ExpertHealth``s
  on clocks that only the test advances; ``snapshot()``, both masks
  and every predicate must be identical after each step, through
  cooldowns and half-open breakers.
* ``fallback_choice`` agrees with the JAX one on seeded score vectors,
  masks and budgets.
* Engine parity (``torch_serving_util``: same Results in the same
  order, same counters): one expert forced down; failures injected
  through ``engine.scheduler`` during ``serve()`` with re-routes; and
  with ``fallback_max_depth=0`` or no tracker, where failed Results
  are terminal.
"""

import numpy as np
import pytest

from repro_torch.core.objective import fallback_choice
from repro_torch.serving import ExpertHealth
from repro_torch.serving import Request as TRequest
from torch_serving_util import (Clock, JRequest, assert_same_results,
                                assert_same_stats, make_engines,
                                make_weights, requests, workload)
from torch_threads import one_torch_thread  # noqa: F401

from repro.core.objective import fallback_choice as jax_fallback_choice
from repro.serving import ExpertHealth as JHealth


@pytest.fixture(scope="module")
def weights(tiny_library):
    return make_weights(tiny_library)


# ---------------------------------------------------- the tracker alone


def _state(h, n):
    return (h.snapshot(), list(h.healthy_mask()), list(h.available_mask()),
            [(h.healthy(i), h.overloaded(i), h.available(i))
             for i in range(n)],
            [vars(s) for s in h.states])


@pytest.mark.parametrize("seed", range(6))
def test_health_matches_jax_on_random_observations(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    knobs = dict(depth_alpha=float(rng.choice([0.3, 1.0])),
                 failure_alpha=float(rng.choice([0.4, 0.5])),
                 overload_depth=float(rng.choice([4.0, 64.0])),
                 cooldown_s=float(rng.choice([0.0, 0.5, 30.0])))
    clocks = (Clock(0.0), Clock(0.0))
    hs = (JHealth(n, now_fn=clocks[0], **knobs),
          ExpertHealth(n, now_fn=clocks[1], **knobs))
    for _ in range(200):
        op, i = int(rng.integers(6)), int(rng.integers(n))
        depth, lat = int(rng.integers(0, 12)), float(rng.random() * 0.1)
        dt = float(rng.choice([0.01, 0.2, 1.0]))
        for h, clock in zip(hs, clocks):
            if op == 0:
                h.observe_lane_depth(i, depth)
            elif op == 1:
                h.observe_flush(i, lat, ok=True)
            elif op == 2:
                h.record_failure(i)
            elif op == 3:
                h.force_down(i, down=bool(depth % 2))
            else:
                clock.advance(dt)
        assert _state(hs[1], n) == _state(hs[0], n)


@pytest.mark.parametrize("seed", range(4))
def test_fallback_choice_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        m = int(rng.integers(2, 7))
        scores = rng.normal(size=m)
        if rng.random() < 0.3:                  # exact ties
            scores = np.round(scores)
        healthy = rng.random(m) < 0.7
        available = healthy & ~(rng.random(m) < 0.3)
        choice, order = int(rng.integers(m)), list(rng.permutation(m))
        depth = int(rng.integers(0, m + 2))
        assert fallback_choice(scores, healthy, available, choice, order,
                               depth) == jax_fallback_choice(
            scores, healthy, available, choice, order, depth)


def test_cooldown_holds_then_half_opens():
    """tests/test_health.py's breaker cases, on the port."""
    clock = Clock(0.0)
    h = ExpertHealth(3, cooldown_s=10.0, now_fn=clock)
    h.record_failure(0)
    assert not h.healthy(0) and list(h.available_mask()) == [False, True,
                                                             True]
    for _ in range(4):
        h.observe_flush(0, 0.01, ok=True)
    assert h.states[0].failure_ewma < h.fail_threshold
    clock.t = 9.9
    assert not h.healthy(0)
    clock.t = 10.1
    assert h.healthy(0)
    h.record_failure(0)                         # half-open -> open again
    assert not h.healthy(0)
    h.force_down(1)
    assert not h.available(1)
    h.force_down(1, down=False)
    assert h.available(1)
    with pytest.raises(AssertionError):
        ExpertHealth(0)


# ---------------------------------------------------- inside the engine


def _health_pair(**kw):
    jh, th = JHealth(3, now_fn=Clock(), **kw), ExpertHealth(3, now_fn=Clock(),
                                                            **kw)
    return {"jax_knobs": {"health": jh}, "port_knobs": {"health": th}}


def _serve_both(jeng, teng, work, inject=None):
    """``serve()`` on both engines; ``inject(engine)`` runs from inside
    the request iterator before its first request."""
    out = []
    for eng, cls in ((jeng, JRequest), (teng, TRequest)):
        def stream(eng=eng, cls=cls):
            for i, req in enumerate(requests(cls, work)):
                if i == 0 and inject is not None:
                    inject(eng)
                yield req
        out.append(list(eng.serve(stream())))
    assert_same_results(*out)
    assert_same_stats(jeng, teng)
    assert sorted(r.uid for r in out[1]) == sorted(w["uid"] for w in work)
    return out[1]


def test_all_healthy_tracker_changes_nothing(tiny_library, weights):
    """A tracker with every expert healthy: the same Results as the JAX
    engine's and as the port's engine without one."""
    work = workload(cascade=True)[:128]
    jeng, teng = make_engines(tiny_library, weights, lane_target=8,
                              max_wait_s=1e9, fused_cascade=True,
                              **_health_pair())
    got = _serve_both(jeng, teng, work)
    _, plain = make_engines(tiny_library, weights, lane_target=8,
                            max_wait_s=1e9, fused_cascade=True)
    ref = list(plain.serve(iter(requests(TRequest, work))))
    assert_same_results(ref, got)
    assert teng.stats.fallbacks == 0


@pytest.mark.parametrize("down", [0, 1, 2])
def test_force_down_matches_jax(tiny_library, weights, down):
    """Route-time fallback around a forced-down expert, cache hits
    included: no Result names it."""
    pair = _health_pair()
    for knobs in pair.values():
        knobs["health"].force_down(down)
    jeng, teng = make_engines(tiny_library, weights, max_wait_s=10.0,
                              fused_cascade=True, **pair)
    got = _serve_both(jeng, teng, workload(cascade=True))
    assert all(r.expert != tiny_library.experts[down].name for r in got)
    assert teng.stats.fallbacks > 0
    assert teng.stats.fallbacks == sum(r.fallback_depth > 0 for r in got)


@pytest.mark.parametrize("count", [-1, 2])
@pytest.mark.parametrize("expert", [0, 2])
def test_injected_failures_reroute_like_jax(tiny_library, weights, expert,
                                            count):
    """``inject_failures`` during ``serve()``: the failed flushes'
    entries re-route through the fallback chain; nothing fails."""
    jeng, teng = make_engines(tiny_library, weights, lane_target=8,
                              max_wait_s=1e9, fused_cascade=True,
                              fallback_max_depth=2,
                              **_health_pair(cooldown_s=0.0))
    got = _serve_both(jeng, teng, workload(cascade=True)[:128],
                      lambda eng: eng.scheduler.inject_failures(expert,
                                                                count))
    st = teng.stats
    assert st.reroutes > 0 and st.failed == 0
    assert st.expert_failures[tiny_library.experts[expert].name] >= 1
    assert any(r.fallback_depth > 0 for r in got)


@pytest.mark.parametrize("tracker", [True, False],
                         ids=["fallback_max_depth_0", "no_tracker"])
def test_failed_flushes_are_terminal_without_fallback(tiny_library,
                                                      weights, tracker):
    pair = _health_pair() if tracker else {}
    jeng, teng = make_engines(tiny_library, weights, lane_target=8,
                              max_wait_s=1e9, fallback_max_depth=0, **pair)
    got = _serve_both(jeng, teng, workload()[:128],
                      lambda eng: eng.scheduler.inject_failures(1))
    failed = [r for r in got if r.failed]
    assert failed and teng.stats.failed == len(failed)
    assert teng.stats.reroutes == 0
    for r in failed:
        assert (r.flush_reason, r.loss, r.predictions.size) == (
            "failed", None, 0)
    assert teng.stats.served == 128 - len(failed)


def test_engine_refuses_a_tracker_of_another_size(weights):
    _, router, port_rc, port_lib = weights
    from repro_torch.serving import TryageEngine
    with pytest.raises(ValueError, match="health tracker"):
        TryageEngine(port_lib, router, port_rc, health=ExpertHealth(2),
                     device="cpu")
