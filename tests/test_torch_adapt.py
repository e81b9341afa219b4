"""Online router adaptation in the port's engine against the JAX
engine's.

The JAX ``TryageEngine(use_kernel=True)`` and the port's engine on the
CPU serve the same mixed-flag workload over the same ``tiny_library``
and router weights (with an uncertainty head, carried across by
``repro_torch.bridge``), each on its own test clock
(``tests/torch_serving_util.py``), with ``adapt_every`` 4 and 8 and
``adapt_trainable`` ``"head"`` and ``"all"``, through ``run()`` and
``serve()``.  Feedback is published per flush, so both engines replay
the same samples (the same ``adapt_seed``) into the same updates.

Exact: the number of updates, the ``router_version`` seen after every
Result, the decision (expert, ``cached``, depth, flush) per uid, the
cache invariant after every swap, the adaptation block of
``summary()`` except its pre/post errors and time, and the adaptation
series of the metrics export.  Tolerance: pre/post errors, losses and
predicted losses to rtol = atol = 1e-5 (f32 sums in other orders).  A
decision may differ only where the top-two constrained-score gap is
under 1e-5 (``PERF.md`` section 2); no case here comes near one.
"""

import numpy as np
import pytest

from repro_torch.serving import Request as TRequest
from repro_torch.serving import TryageEngine as TEngine
from repro_torch.serving.metrics import render
from torch_serving_util import (ATOL, RTOL, Clock, JRequest,  # noqa: F401
                                make_engines, make_weights, workload)
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")

from repro.serving.metrics import render as jax_render  # noqa: E402

ADAPT_SERIES = ("tryage_adapt_updates_total", "tryage_feedback_events_total",
                "tryage_router_version", "tryage_replay_occupancy")


@pytest.fixture(scope="module")
def weights(tiny_library):
    return make_weights(tiny_library)


def _drive(eng, request_cls, work, discipline):
    """Results in order, with the router version live after each."""
    versions = []
    if discipline == "run":
        for w in work:
            eng.submit(request_cls(**w))
        out = eng.run()
        versions = [eng.router_version] * len(out)
    else:
        clock = eng._now

        def arrivals():
            for w in work:
                clock.advance(0.004)
                yield request_cls(**w)

        out = []
        for r in eng.serve(arrivals()):
            out.append(r)
            versions.append(eng.router_version)
    return out, versions


def _series(text):
    return [ln for ln in text.splitlines() if ln.startswith(ADAPT_SERIES)]


@pytest.mark.parametrize("discipline", ["run", "serve"])
@pytest.mark.parametrize("every,trainable", [(4, "head"), (8, "all")])
def test_adaptation_matches_jax(tiny_library, weights, discipline, every,
                                trainable):
    # the engine's default adapt_lr (1e-2)
    knobs = dict(adapt_every=every, adapt_trainable=trainable,
                 adapt_ema=0.25, adapt_batch=8,
                 replay_cap=64, adapt_seed=3, fused_cascade=True)
    if discipline == "serve":
        knobs.update(lane_target=8, max_wait_s=0.02)
    jeng, teng = make_engines(tiny_library, weights, **knobs)
    for eng in (jeng, teng):
        eng._now = Clock()
    work = workload(cascade=True)[:128]
    ref, jv = _drive(jeng, JRequest, work, discipline)
    got, tv = _drive(teng, TRequest, work, discipline)

    assert teng.stats.adapt_updates == jeng.stats.adapt_updates > 3
    assert teng.router_version == teng.stats.adapt_updates
    assert tv == jv
    assert [r.uid for r in got] == [r.uid for r in ref]
    for a, b in zip(ref, got):
        assert (b.expert, b.cached, b.cascade_depth, b.flush_reason) == (
            a.expert, a.cached, a.cascade_depth, a.flush_reason), a.uid
    for field in ("loss", "confidence"):
        np.testing.assert_allclose([getattr(r, field) for r in got],
                                   [getattr(r, field) for r in ref],
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    np.testing.assert_allclose(np.stack([r.pred_losses for r in got]),
                               np.stack([r.pred_losses for r in ref]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        [teng.stats.adapt_pre_err, teng.stats.adapt_post_err],
        [jeng.stats.adapt_pre_err, jeng.stats.adapt_post_err],
        rtol=RTOL, atol=ATOL)
    assert not teng.cache.stale_versions(teng.router_version)
    want, have = (e.stats.summary()["adaptation"] for e in (jeng, teng))
    for key in ("pre_err", "post_err", "time_s"):
        want.pop(key), have.pop(key)
    assert have == want
    names = [e.name for e in tiny_library.experts]
    assert _series(render(teng.stats, None, names)) == _series(
        jax_render(jeng.stats, None, names))


def test_frozen_engine_never_updates(tiny_library, weights):
    _, teng = make_engines(tiny_library, weights)
    for w in workload()[:64]:
        teng.submit(TRequest(**w))
    teng.run()
    assert teng.stats.adapt_updates == teng.router_version == 0
    assert teng.stats.feedback_events > 0


def test_swap_clears_the_cache_and_checks_versions(tiny_library, weights):
    _, teng = make_engines(tiny_library, weights, adapt_every=4,
                           adapt_batch=4, replay_cap=16)
    for w in workload()[:8]:
        teng.submit(TRequest(**w))
    teng.run()
    assert teng.router_version >= 1 and len(teng.cache) == 0
    # a stale entry left behind is caught
    teng.cache.put(("k", teng.router_version - 1), np.zeros(3), 0)
    with pytest.raises(RuntimeError, match="stale|version"):
        teng._assert_cache_version()


def test_adaptation_knobs_are_validated(weights):
    _, router, rc, lib = weights
    with pytest.raises(ValueError, match="replay"):
        TEngine(lib, router, rc, adapt_every=8, replay_cap=0, device="cpu")
    with pytest.raises(ValueError, match="adapt_batch"):
        TEngine(lib, router, rc, adapt_batch=0, device="cpu")
    with pytest.raises(ValueError, match="trainable"):
        TEngine(lib, router, rc, adapt_every=8, adapt_trainable="encoder",
                device="cpu")
