"""Shared setup of the port's serving parity tests
(``tests/test_torch_{serve,health,frontend,metrics}.py``).

The JAX ``TryageEngine(use_kernel=True)`` and the port's engine on the
CPU run over the same ``tiny_library`` and router weights (with an
uncertainty head), carried across by ``repro_torch.bridge``, on the
geometry and 256-request mixed-flag workload of
``tests/test_torch_engine.py``.  Each engine reads its own clock that
only the test advances (``Clock``), so deadlines, admissions and
latencies do not depend on how often an engine reads it, and latencies
compare exactly.

Exact: Result order, uid, expert, ``cached``, ``cascade_depth``,
``flush_reason``, ``fallback_depth``, ``failed`` and latency, and the
counters.  Tolerance: loss, accuracy, confidence and ``pred_losses`` to
rtol = atol = 1e-5 (XLA and PyTorch on the CPU sum in other orders).
"""

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.core import objective as tobj
from repro_torch.core import router as trouter
from repro_torch.serving import TryageEngine as TEngine
from test_torch_engine import RC
from test_torch_engine import _workload as workload  # noqa: F401

jax = pytest.importorskip("jax")

from repro.core.objective import recency_constraint, size_constraint  # noqa: E402
from repro.core.router import init_router  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402, F401
from repro.serving import TryageEngine as JEngine  # noqa: E402

RTOL = ATOL = 1e-5
# counters both engines fill, compared exactly after every run
STATS = ("served", "per_expert", "total_flops", "router_batches",
         "bucket_hits", "padded_rows", "flushes", "lane_peaks",
         "cache_hits", "cache_misses", "cache_key_dropped_lambda",
         "escalations", "cascade_depth_hist", "spec_launched", "spec_hits",
         "spec_cancelled", "spec_wasted", "spec_wasted_tokens",
         "feedback_events", "feedback_dropped", "replay_len", "sessions",
         "admitted", "shed", "shed_by_priority", "admission_queue_peak",
         "fallbacks", "fallback_depth_hist", "degraded", "reroutes",
         "failed", "expert_failures")


class Clock:
    """A clock that moves only when the test advances it."""

    def __init__(self, t=1.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_weights(tiny_library):
    """(JAX router params, port router, port RouterConfig, port library)."""
    rp, _ = init_router(jax.random.PRNGKey(9), RC, uncertainty=True)
    port_rc = trouter.RouterConfig(**vars(RC))
    return (rp, bridge.router_from_jax(rp, port_rc, device="cpu"), port_rc,
            bridge.library_from_jax(tiny_library, device="cpu"))


def make_engines(tiny_library, weights, jax_knobs=None, port_knobs=None,
                 **knobs):
    """A JAX engine and a port engine with the same knobs, each on its
    own ``Clock`` (``engine._now``).  ``jax_knobs`` / ``port_knobs``
    carry objects each package builds for itself (``health``)."""
    rp, router, port_rc, port_lib = weights
    knobs.setdefault("max_batch", 32)
    jeng = JEngine(tiny_library, rp, RC,
                   [size_constraint(tiny_library),
                    recency_constraint(tiny_library)],
                   use_kernel=True, now_fn=Clock(), **knobs,
                   **(jax_knobs or {}))
    teng = TEngine(port_lib, router, port_rc,
                   [tobj.size_constraint(port_lib),
                    tobj.recency_constraint(port_lib)],
                   now_fn=Clock(), device="cpu", **knobs,
                   **(port_knobs or {}))
    return jeng, teng


def requests(request_cls, work):
    return [request_cls(**w) for w in work]


def assert_same_results(ref, got):
    """Same Results in the same order: exact decisions, flush labels,
    latencies; floats within RTOL / ATOL."""
    assert [r.uid for r in got] == [r.uid for r in ref]
    for a, b in zip(ref, got):
        assert (b.expert, b.cached, b.cascade_depth, b.flush_reason,
                b.fallback_depth, b.failed, b.latency_s, b.flops_proxy) == (
            a.expert, a.cached, a.cascade_depth, a.flush_reason,
            a.fallback_depth, a.failed, a.latency_s, a.flops_proxy), a.uid
        assert (b.loss is None) == (a.loss is None), a.uid
        assert b.predictions.shape == a.predictions.shape, a.uid
    served = [i for i, r in enumerate(ref) if r.loss is not None]
    for field in ("loss", "accuracy"):
        np.testing.assert_allclose(
            [getattr(got[i], field) for i in served],
            [getattr(ref[i], field) for i in served],
            rtol=RTOL, atol=ATOL, err_msg=field)
    np.testing.assert_allclose([r.confidence for r in got],
                               [r.confidence for r in ref],
                               rtol=RTOL, atol=ATOL, err_msg="confidence")
    np.testing.assert_allclose(np.stack([r.pred_losses for r in got]),
                               np.stack([r.pred_losses for r in ref]),
                               rtol=RTOL, atol=ATOL, err_msg="pred_losses")


def assert_same_stats(jeng, teng):
    for field in STATS:
        a, b = getattr(jeng.stats, field), getattr(teng.stats, field)
        if isinstance(a, dict):
            a, b = dict(a), dict(b)
        assert b == a, field
    assert list(teng.stats.latencies) == list(jeng.stats.latencies)
    # summary(): the sections both packages fill, in the JAX layout
    ref, got = jeng.stats.summary(), teng.stats.summary()
    for key in ("served", "per_expert", "total_flops", "router_batches",
                "bucket_hits", "padded_rows", "flushes", "lane_peaks",
                "latency", "cascade", "speculation", "frontend",
                "fallback"):
        assert got[key] == ref[key], key
