"""The port's ``TryageEngine.run()`` against the JAX engine's.

The 256-request mixed-flag workload of ``tests/test_pipeline.py`` (192
unique prompts, the tail repeating the first 64 with the same flags, so
the decision cache sees 64 hits), served with ``max_batch=32`` by the
JAX ``TryageEngine(use_kernel=True)`` and by the port's engine on the
CPU, over the same ``tiny_library`` weights and router weights (with an
uncertainty head) carried across by ``repro_torch.bridge``, both on one
injected clock.  Run single-shot, with confidence floors on
``fused_cascade=True`` (the one-launch cascade decision) and on the
staged sigma pass, and single-shot without the decision cache and
without bucket padding.

Exact: expert choice, ``cached``, ``cascade_depth`` and
``flush_reason`` per uid, the cache hits (64 with the cache) and their
count by tier (``{"t1": 64}``), and the summary's cache block.  Tolerance: loss,
accuracy and confidence agree to rtol=1e-5, atol=1e-5 (XLA and PyTorch
on the CPU reduce in different orders).
"""

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.core import objective as tobj
from repro_torch.core import router as trouter
from repro_torch.serving import Request as TRequest
from repro_torch.serving import TryageEngine as TEngine
from torch_threads import one_torch_thread  # noqa: F401

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax  # noqa: E402
from repro.core.objective import recency_constraint, size_constraint  # noqa: E402
from repro.core.router import RouterConfig, init_router  # noqa: E402
from repro.data.batching import mlm_batch  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import TryageEngine as JEngine  # noqa: E402


RTOL = ATOL = 1e-5
RC = RouterConfig(n_models=3, vocab_size=64, num_layers=1, d_model=32,
                  num_heads=2, d_ff=64)
# per-request confidence floors of the cascade run: some rows escalate,
# some keep their first pick, a few walk to depth 2
THRESHOLDS = [0.55, 0.6, 0.65, 0.99]


class Clock:
    def __init__(self, t=1.0):
        self.t = t

    def __call__(self):
        self.t += 1e-3
        return self.t


def _workload(n=256, n_unique=192, seed=0, cascade=False):
    """tests/test_pipeline.py's generator, as plain field dicts."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 64, size=(n_unique, 32)).astype(np.int32)
    mb = mlm_batch(toks, rng, 0.2, 64)
    mix = [{}, {"size": 1.0}, {"size": 8.0}, {"recency": 2.0}]
    return [dict(uid=i, tokens=mb["tokens"][i % n_unique],
                 targets=mb["targets"][i % n_unique],
                 mask=mb["mask"][i % n_unique], lambdas=mix[i % len(mix)],
                 min_confidence=(THRESHOLDS[i % len(THRESHOLDS)]
                                 if cascade else 0.0))
            for i in range(n)]


@pytest.fixture(scope="module")
def weights(tiny_library):
    rp, _ = init_router(jax.random.PRNGKey(9), RC, uncertainty=True)
    port_rc = trouter.RouterConfig(**vars(RC))
    return (rp, bridge.router_from_jax(rp, port_rc, device="cpu"), port_rc,
            bridge.library_from_jax(tiny_library, device="cpu"))


def _serve(engine, request_cls, work):
    for w in work:
        engine.submit(request_cls(**w))
    return {r.uid: r for r in engine.run()}


@pytest.mark.parametrize("cascade,fused,cache", [
    (False, False, True), (True, True, True), (True, False, True),
    (False, False, False)],
    ids=["single_shot", "fused_cascade", "staged_cascade",
         "no_cache_no_buckets"])
def test_engine_matches_jax(tiny_library, weights, cascade, fused, cache):
    rp, router, port_rc, port_lib = weights
    work = _workload(cascade=cascade)
    knobs = dict(max_batch=32, fused_cascade=fused, decision_cache=cache,
                 buckets=cache)
    jeng = JEngine(tiny_library, rp, RC,
                   [size_constraint(tiny_library),
                    recency_constraint(tiny_library)],
                   use_kernel=True, now_fn=Clock(), **knobs)
    teng = TEngine(port_lib, router, port_rc,
                   [tobj.size_constraint(port_lib),
                    tobj.recency_constraint(port_lib)],
                   now_fn=Clock(), device="cpu", **knobs)
    calls = []
    if fused:
        orig = teng._score_cascade_batch
        teng._score_cascade_batch = (
            lambda reqs: (calls.append(len(reqs)), orig(reqs))[1])
    ref = _serve(jeng, JRequest, work)
    got = _serve(teng, TRequest, work)

    assert sorted(got) == sorted(ref) == list(range(256))
    for uid in ref:
        a, b = ref[uid], got[uid]
        assert (b.expert, b.cached, b.cascade_depth, b.flush_reason) == (
            a.expert, a.cached, a.cascade_depth, a.flush_reason), uid
    assert teng.stats.cache_hits == jeng.stats.cache_hits == (64 if cache
                                                               else 0)
    # every hit counts under its tier: T1 on both engines
    assert dict(teng.stats.cache_tier_hits) == dict(
        jeng.stats.cache_tier_hits) == ({"t1": 64} if cache else {})
    assert teng.stats.summary()["cache"] == jeng.stats.summary()["cache"]
    assert teng.stats.escalations == jeng.stats.escalations
    assert dict(teng.stats.bucket_hits) == dict(jeng.stats.bucket_hits)
    uids = sorted(ref)
    for field in ("loss", "accuracy", "confidence"):
        np.testing.assert_allclose([getattr(got[u], field) for u in uids],
                                   [getattr(ref[u], field) for u in uids],
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    np.testing.assert_allclose(np.stack([got[u].pred_losses for u in uids]),
                               np.stack([ref[u].pred_losses for u in uids]),
                               rtol=RTOL, atol=ATOL)
    if cascade:
        # the comparison means something only if rows escalated, some
        # stayed, and the one-launch path really decided them
        depths = [ref[u].cascade_depth for u in uids]
        assert 0 < sum(d > 0 for d in depths) < 256
    assert bool(calls) == fused
    assert teng.stats.router_batches == jeng.stats.router_batches


def test_engine_refuses_modules_on_another_device(weights):
    _, router, port_rc, port_lib = weights
    with pytest.raises(ValueError, match="lives on"):
        TEngine(port_lib, router, port_rc, device="meta")
