"""The port's ``TryageEngine.serve()`` against the JAX engine's.

Both engines stream the 256-request mixed-flag workload of
``tests/test_torch_engine.py`` (``max_batch=32``) and must give the same
Results in the same order, with the same flush reasons, latencies and
counters (``torch_serving_util`` states what is exact and what is held
to rtol = atol = 1e-5).  Cases: (a) no cascade; (b) confidence floors
on the one-launch cascade decision; (c) floors on the staged sigma
pass; (d) a trickle with idle ticks and deadline flushes; (e)
speculative escalation, on the default schedule, the cancel schedule
(nothing flushes before a verdict) and the waste schedule (everything
flushes before its verdict); (f) a queue submitted before ``serve()``.
"""

import pytest

from repro_torch.serving import Request as TRequest
from torch_serving_util import (JRequest, assert_same_results,
                                assert_same_stats, make_engines,
                                make_weights, requests, workload)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights(tiny_library):
    return make_weights(tiny_library)


def _stream(eng, request_cls, work):
    return list(eng.serve(iter(requests(request_cls, work))))


def _both(jeng, teng, work, stream=_stream):
    ref = stream(jeng, JRequest, work)
    got = stream(teng, TRequest, work)
    assert_same_results(ref, got)
    assert_same_stats(jeng, teng)
    assert sorted(r.uid for r in got) == sorted(w["uid"] for w in work)
    return ref, got


@pytest.mark.parametrize("cascade,fused", [
    (False, False), (True, True), (True, False)],
    ids=["a_single_shot", "b_fused_cascade", "c_staged_cascade"])
def test_serve_matches_jax(tiny_library, weights, cascade, fused):
    jeng, teng = make_engines(tiny_library, weights, max_wait_s=10.0,
                              fused_cascade=fused)
    ref, _ = _both(jeng, teng, workload(cascade=cascade))
    st = teng.stats
    # full buckets first, the ragged tails at shutdown; the tail of the
    # workload repeats 64 prompts, which the decision cache answers
    assert st.flushes["target"] > 0 and st.flushes["drain"] > 0
    assert st.cache_hits == 64
    if cascade:
        assert 0 < st.escalations < 256
        assert any(name.endswith("@esc") for name in st.lane_peaks)


def test_serve_trickle_with_idle_ticks(tiny_library, weights):
    """(d): one request a tick, the clock +0.01 a tick, an idle tick
    after every fourth request, ``max_wait_s=0.05``: partial admission
    batches and deadline flushes, latencies compared exactly."""
    jeng, teng = make_engines(tiny_library, weights, max_wait_s=0.05,
                              fused_cascade=True)

    def stream(eng, request_cls, work):
        def arrivals():
            for i, req in enumerate(requests(request_cls, work)):
                yield req
                eng._now.advance(0.01)
                if i % 4 == 3:
                    yield None
            for _ in range(8):              # quiet tail: deadlines fire
                eng._now.advance(0.01)
                yield None
        return list(eng.serve(arrivals()))

    ref, _ = _both(jeng, teng, workload(cascade=True), stream)
    st = teng.stats
    assert st.flushes["deadline"] > 0 and st.router_batches > 8
    assert st.latency_percentiles()["p95_s"] > 0.0
    assert st.latency_percentiles() == jeng.stats.latency_percentiles()


@pytest.mark.parametrize("lane_target,max_wait_s", [
    (None, 10.0), (100, 100.0), (1, 100.0)],
    ids=["e_default", "e_cancel", "e_waste"])
def test_serve_speculation_matches_jax(tiny_library, weights, lane_target,
                                       max_wait_s):
    """(e): speculative escalation with confidence floors; the
    speculation counters equal the JAX engine's and balance."""
    n = 256 if lane_target is None else 64
    jeng, teng = make_engines(tiny_library, weights, lane_target=lane_target,
                              max_wait_s=max_wait_s, fused_cascade=True,
                              speculate=True)
    _both(jeng, teng, workload(cascade=True)[:n])
    st = teng.stats
    assert st.spec_launched > 0
    assert st.spec_launched == st.spec_hits + st.spec_cancelled + st.spec_wasted
    assert st.served == n
    if lane_target == 100:
        assert st.spec_cancelled > 0 and st.spec_wasted == 0
    if lane_target == 1:
        assert st.spec_wasted > 0 and st.spec_cancelled == 0
        assert st.spec_wasted_tokens == 32 * st.spec_wasted


def test_serve_presubmitted_queue(tiny_library, weights):
    """(f): requests ``submit()``ted before ``serve()`` are admitted
    first and leave the queue empty."""
    jeng, teng = make_engines(tiny_library, weights, max_wait_s=10.0,
                              fused_cascade=True)
    work = workload(cascade=True)

    def stream(eng, request_cls, work):
        for req in requests(request_cls, work[:160]):
            eng.submit(req)
        out = list(eng.serve(iter(requests(request_cls, work[160:]))))
        assert not eng.queue
        return out

    _both(jeng, teng, work, stream)


def test_run_is_unchanged_by_the_serve_knobs(tiny_library, weights):
    """``run()`` ignores ``speculate`` and the lane knobs: the FIFO
    drain flushes every group at once, labelled ``fifo``."""
    jeng, teng = make_engines(tiny_library, weights, max_wait_s=0.0,
                              lane_target=4, speculate=True,
                              fused_cascade=True)

    def stream(eng, request_cls, work):
        for req in requests(request_cls, work):
            eng.submit(req)
        return eng.run()

    _, got = _both(jeng, teng, workload(cascade=True)[:96], stream)
    assert {r.flush_reason for r in got} == {"fifo"}
    assert teng.stats.spec_launched == 0 and teng.scheduler is None
