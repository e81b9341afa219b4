"""The port's decision-cache tiers against the JAX package's.

Stack level, on random inputs (hypothesis where installed):

* ``DecisionCache.key``, ``encode_key`` and ``encode_verdict`` give the
  same tuples and the same bytes in both packages, and each package's
  ``decode_verdict`` reads the other's verdict back;
* ``DecisionCacheStack`` (T1 over a ``MemoryKVStore`` T2 and a
  ``SemanticCache`` T3) answers random put / exact probe / semantic
  probe / version bump / clear streams with the same entries and the
  same tiers, and leaves the same T2 bytes;
* ``ExactNNIndex`` returns the same ``(id, d2)`` and ``SemanticCache``
  the same ``(entry, status)``; ``calibrate_eps`` is exactly equal.

Engine level, the JAX ``TryageEngine(use_kernel=True)`` and the port's
engine on the CPU over ``tiny_library`` and the same router weights
(``tests/torch_serving_util.py``, clocks that only the test advances):

* a T1-only stack is the plain cache (the 256-request workload of
  ``tests/test_torch_engine.py``, ``{"t1": 64}``);
* two replicas over one ``MemoryKVStore``: the second serves all 48
  requests from T2 (``{"t2": 48}``), and both packages' stores hold the
  same keys and verdicts;
* paraphrases (one token of an earlier prompt replaced) through T3 at an
  eps that half of them fall within, single-shot and with the cascade
  on (the fused kernel is bypassed for exact misses, as in the JAX
  engine);
* every tier under online adaptation (no stale version survives);
* a ``DiskKVStore`` directory written by one package's engine and
  served by the other's entirely from T2.

Exact: expert, ``cached``, ``cascade_depth``, flush reason and latency
per uid, every counter (tier hits, revalidations and rejects included)
and, for verdicts read back from T2, ``pred_losses`` bit for bit.
Tolerance: freshly scored ``pred_losses``, losses and confidences to
rtol = atol = 1e-5 (XLA and PyTorch on the CPU sum in other orders).
"""

import numpy as np
import pytest

from hyputil import given, settings, st
from repro_torch.serving import Request as TRequest
from repro_torch.serving import cache as tcache
from repro_torch.serving import kvstore as tkv
from repro_torch.serving import semcache as tsem
from test_torch_engine import _workload
from torch_serving_util import (JRequest, assert_same_results,
                                assert_same_stats, make_engines,
                                make_weights)
from torch_threads import one_torch_thread  # noqa: F401

pytest.importorskip("jax")

from repro.serving import cache as jcache  # noqa: E402
from repro.serving import kvstore as jkv  # noqa: E402
from repro.serving import semcache as jsem  # noqa: E402

CNAMES = ["size", "recency"]
FLAGS = [{}, {"size": 1.0}, {"size": 8.0}, {"recency": 2.0}]


@pytest.fixture(scope="module")
def weights(tiny_library):
    return make_weights(tiny_library)


# ----------------------------------------------------------- the codecs


@given(toks=st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=12),
       rows=st.sampled_from([1, 2]),
       lam=st.dictionaries(st.sampled_from(CNAMES + ["sise"]),
                           st.floats(0, 16, allow_nan=False), max_size=3),
       min_conf=st.sampled_from([0.0, 0.6, 0.99]),
       version=st.integers(0, 2**40),
       pred=st.lists(st.floats(-1e6, 1e6, allow_nan=False, width=32),
                     min_size=1, max_size=11),
       choice=st.integers(0, 10), depth=st.integers(0, 3),
       conf=st.floats(0, 1))
@settings(max_examples=80, deadline=None)
def test_codecs_are_byte_identical(toks, rows, lam, min_conf, version, pred,
                                   choice, depth, conf):
    arr = np.array(toks * rows, np.int32).reshape(rows, -1)
    keys = [mod.DecisionCache.key(arr, lam, CNAMES, min_conf, version,
                                  unknown_sink=lambda names: None)
            for mod in (jcache, tcache)]
    assert keys[1] == keys[0]
    assert tcache.encode_key(keys[1]) == jcache.encode_key(keys[0])
    row = np.array(pred, np.float32)
    bufs = [mod.encode_verdict(row, choice, depth, conf)
            for mod in (jcache, tcache)]
    assert bufs[1] == bufs[0]
    for reader, buf in ((tcache, bufs[0]), (jcache, bufs[1])):
        got = reader.decode_verdict(buf)
        np.testing.assert_array_equal(got[0], row)
        assert got[1:] == (choice, depth, conf)
        assert not got[0].flags.writeable


# ----------------------------------------------- the stack, op by op


_stack_ops = st.lists(
    st.one_of(
        st.tuples(st.just("put"), st.integers(0, 5), st.booleans()),
        st.tuples(st.just("get"), st.integers(0, 5), st.just(False)),
        st.tuples(st.just("sem"), st.integers(0, 5), st.booleans()),
        st.tuples(st.sampled_from(["bump", "advance", "clear", "evict"]),
                  st.just(0), st.just(False))),
    min_size=1, max_size=60)


def _stack(mod, kv_mod, sem_mod, capacity, eps, cap):
    return mod.DecisionCacheStack(capacity, kv=kv_mod.MemoryKVStore(),
                                  semantic=sem_mod.SemanticCache(eps, cap))


def _same_entry(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(b[0], a[0])
    assert tuple(b[1:]) == tuple(a[1:])


@given(ops=_stack_ops, capacity=st.integers(1, 4),
       flags=st.integers(0, 3), cap=st.integers(1, 8))
@settings(max_examples=60, deadline=None)
def test_stack_matches_jax_stack(ops, capacity, flags, cap):
    rng = np.random.default_rng(len(ops))
    base = rng.normal(size=(6, 8)).astype(np.float32)
    stacks = [_stack(jcache, jkv, jsem, capacity, 0.5, cap),
              _stack(tcache, tkv, tsem, capacity, 0.5, cap)]
    version = 0
    for i, (op, k, near) in enumerate(ops):
        key = jcache.DecisionCache.key(np.array([k], np.int32),
                                       FLAGS[(k + flags) % 4], CNAMES,
                                       0.0, version)
        emb = base[k] + (0.05 if near else 0.0)
        if op in ("bump", "advance"):
            # a swap clears the in-memory tiers; "advance" does not, so
            # T3 holds entries of a superseded version for the probes
            version += 1
            if op == "bump":
                for s in stacks:
                    s.clear()
        elif op == "clear":
            for s in stacks:
                s.clear()
        elif op == "evict":
            # a T1 eviction storm: the next probes fall back to T2
            for s in stacks:
                s.t1.clear()
        elif op == "put":
            for s in stacks:
                s.put(key, np.full(3, i, np.float32), i % 3, depth=i % 2,
                      confidence=0.5, emb=emb if near else None)
        elif op == "get":
            (a, ta), (b, tb) = (s.lookup(key) for s in stacks)
            _same_entry(a, b)
            assert tb == ta, i
        else:
            (a, sa), (b, sb) = (s.lookup_semantic(emb, key, version)
                                for s in stacks)
            _same_entry(a, b)
            assert sb == sa, i
        ref, got = stacks
        assert len(got) == len(ref)
        assert len(got.semantic) == len(ref.semantic)
        assert got.stale_versions(version) == ref.stale_versions(version)
        assert {k: got.kv.get(k) for k in got.kv.keys()} == {
            k: ref.kv.get(k) for k in ref.kv.keys()}


# -------------------------------------------------- T3's index and tier


_nn_ops = st.lists(
    st.one_of(
        st.tuples(st.just("add"),
                  st.lists(st.integers(-5, 5), min_size=3, max_size=3)),
        st.tuples(st.just("discard"), st.integers(0, 30)),
        st.tuples(st.just("query"),
                  st.lists(st.integers(-5, 5), min_size=3, max_size=3))),
    min_size=1, max_size=60)


@given(ops=_nn_ops, min_build=st.sampled_from([1, 4, 64]))
@settings(max_examples=80, deadline=None)
def test_nn_index_matches_jax(ops, min_build):
    idx = [jsem.ExactNNIndex(3, min_build=min_build),
           tsem.ExactNNIndex(3, min_build=min_build)]
    ids = []
    for op, val in ops:
        if op == "add":
            a, b = (x.add(np.array(val, np.float32)) for x in idx)
            assert b == a
            ids.append(a)
        elif op == "discard":
            if ids:
                for x in idx:
                    x.discard(ids[val % len(ids)])
        else:
            a, b = (x.query(np.array(val, np.float32)) for x in idx)
            assert b == a
        assert len(idx[1]) == len(idx[0])


@given(seed=st.integers(0, 999), n=st.integers(1, 40),
       cap=st.integers(1, 16), eps=st.sampled_from([0.3, 1.0, 3.0]))
@settings(max_examples=60, deadline=None)
def test_semantic_cache_matches_jax(seed, n, cap, eps):
    rng = np.random.default_rng(seed)
    caches = [jsem.SemanticCache(eps, cap), tsem.SemanticCache(eps, cap)]
    embs = rng.normal(size=(n, 4)).astype(np.float32)
    version = 0
    for i in range(n):
        ctx = (((float(i % 2),), 0.0))
        if rng.random() < 0.15:
            version += 1
        if rng.random() < 0.6:
            pred = rng.normal(size=3)
            for c in caches:
                c.put(embs[i], ctx, version, pred, i % 3)
        q = embs[rng.integers(0, i + 1)] + rng.normal(size=4) * 0.2
        (a, sa), (b, sb) = (c.get(q, ctx, version) for c in caches)
        _same_entry(a, b)
        assert sb == sa and len(caches[1]) == len(caches[0])
        assert (caches[1].stale_versions(version)
                == caches[0].stale_versions(version))


@pytest.mark.parametrize("seed,classes", [(0, 3), (1, 2), (2, 1), (3, 5)])
def test_calibrate_eps_matches_jax(seed, classes):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(48, 32)).astype(np.float32)
    verdicts = rng.integers(0, classes, 48)
    for margin in (0.5, 1.0):
        want = jsem.calibrate_eps(emb, verdicts, margin=margin)
        assert tsem.calibrate_eps(emb, verdicts, margin=margin) == want
    assert (classes == 1) == np.isinf(want)


# ------------------------------------------------------ engine parity


def _run(eng, request_cls, work):
    for w in work:
        eng.submit(request_cls(**w))
    return eng.run()


def _check(jeng, teng, ref, got):
    assert_same_results(ref, got)
    assert_same_stats(jeng, teng)
    for field in ("cache_tier_hits", "cache_revalidations",
                  "cache_revalidation_rejects"):
        a, b = getattr(jeng.stats, field), getattr(teng.stats, field)
        assert (dict(b) if isinstance(b, dict) else b) == (
            dict(a) if isinstance(a, dict) else a), field
    assert (teng.stats.summary()["cache"]
            == jeng.stats.summary()["cache"])


@pytest.mark.parametrize("cascade", [False, True],
                         ids=["single_shot", "fused_cascade"])
def test_t1_only_stack_is_the_plain_cache(tiny_library, weights, cascade):
    jeng, teng = make_engines(tiny_library, weights, fused_cascade=cascade)
    assert type(teng.cache) is tcache.DecisionCache
    teng.cache = tcache.DecisionCacheStack(teng.cache.capacity)
    work = _workload(cascade=cascade)
    ref, got = _run(jeng, JRequest, work), _run(teng, TRequest, work)
    _check(jeng, teng, ref, got)
    assert dict(teng.stats.cache_tier_hits) == {"t1": 64}


def test_replicas_share_verdicts_through_t2(tiny_library, weights):
    kvs = (jkv.MemoryKVStore(), tkv.MemoryKVStore())
    work = _workload(n=48, n_unique=48, seed=11)
    firsts = []
    for _ in range(2):
        jeng, teng = make_engines(tiny_library, weights,
                                  jax_knobs={"cache_kv": kvs[0]},
                                  port_knobs={"cache_kv": kvs[1]})
        ref, got = _run(jeng, JRequest, work), _run(teng, TRequest, work)
        _check(jeng, teng, ref, got)
        firsts.append(got)
    assert dict(teng.stats.cache_tier_hits) == {"t2": 48}
    assert all(r.cached for r in firsts[1])
    for a, b in zip(*firsts):
        assert b.expert == a.expert
        np.testing.assert_array_equal(b.pred_losses, a.pred_losses)
    _same_store(*kvs)


def _same_store(jstore, tstore):
    """The same key bytes; verdicts with the same choice and depth, and
    predicted losses and confidence within tolerance (each package
    scored them itself)."""
    assert sorted(tstore.keys()) == sorted(jstore.keys())
    for k in jstore.keys():
        a = jcache.decode_verdict(jstore.get(k))
        b = tcache.decode_verdict(tstore.get(k))
        assert b[1:3] == a[1:3]
        np.testing.assert_allclose(b[0], a[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b[3], a[3], rtol=1e-5, atol=1e-5)


def _paraphrase_work(cascade):
    """48 prompts, then 48 paraphrases (one token replaced), then the
    first 16 paraphrases again (exact repeats of promoted verdicts)."""
    base = _workload(n=48, n_unique=48, seed=13, cascade=cascade)
    rng = np.random.default_rng(5)
    para = []
    for i, w in enumerate(base):
        t = w["tokens"].copy()
        t[rng.integers(0, t.shape[0])] = rng.integers(4, 64)
        para.append(dict(w, uid=100 + i, tokens=t))
    again = [dict(w, uid=200 + i) for i, w in enumerate(para[:16])]
    return base + para + again


def _split_eps(jeng, work):
    """An eps half the paraphrases' nearest same-context prompts fall
    within, midway between two neighbouring distances (so no distance
    lies near it), from the JAX engine's embeddings."""
    emb = jeng._embed_batch([JRequest(**w) for w in work[:96]])
    ctx = np.arange(48) % 4
    near = np.sort([np.sqrt(((emb[:48][ctx == ctx[i]] - emb[48 + i]) ** 2)
                            .sum(1).min()) for i in range(48)])
    assert near[24] - near[23] > 1e-3 * near[24]
    return float(near[23] + near[24]) / 2


@pytest.mark.parametrize("cascade", [False, True],
                         ids=["single_shot", "fused_cascade"])
def test_semantic_tier_matches_jax(tiny_library, weights, cascade):
    work = _paraphrase_work(cascade)
    probe, _ = make_engines(tiny_library, weights)
    eps = _split_eps(probe, work)
    jeng, teng = make_engines(tiny_library, weights, fused_cascade=cascade,
                              cache_semantic_eps=eps)
    calls = []
    orig = teng._score_from_emb
    teng._score_from_emb = lambda reqs, emb: (calls.append(len(reqs)),
                                              orig(reqs, emb))[1]
    ref, got = _run(jeng, JRequest, work), _run(teng, TRequest, work)
    _check(jeng, teng, ref, got)
    tiers = dict(teng.stats.cache_tier_hits)
    # the comparison means something only if T3 both served and missed
    # paraphrases, and the promoted verdicts then hit T1
    assert 0 < tiers["t3"] < 48 and tiers["t1"] >= 16, tiers
    assert teng.stats.cache_revalidations >= tiers["t3"]
    assert sum(calls) == teng.stats.cache_misses
    if cascade:
        assert any(r.cascade_depth > 0 for r in got)


def test_every_tier_under_adaptation_matches_jax(tiny_library, weights):
    work = _paraphrase_work(cascade=True)
    probe, _ = make_engines(tiny_library, weights)
    eps = _split_eps(probe, work)
    knobs = dict(fused_cascade=True, cache_semantic_eps=eps,
                 adapt_every=8, adapt_batch=8, replay_cap=64, adapt_seed=3)
    jeng, teng = make_engines(tiny_library, weights,
                              jax_knobs={"cache_kv": jkv.MemoryKVStore()},
                              port_knobs={"cache_kv": tkv.MemoryKVStore()},
                              **knobs)
    ref, got = _run(jeng, JRequest, work), _run(teng, TRequest, work)
    _check(jeng, teng, ref, got)
    assert teng.stats.adapt_updates == jeng.stats.adapt_updates > 3
    assert teng.router_version == jeng.router_version
    assert not teng.cache.stale_versions(teng.router_version)
    _same_store(jeng.cache.kv, teng.cache.kv)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_tier_is_shared_between_packages(tiny_library, weights,
                                              tmp_path, writer):
    d = str(tmp_path / "t2")
    work = _workload(n=64, n_unique=64, seed=19, cascade=True)
    knobs = dict(fused_cascade=True, cache_dir=d)
    jeng, teng = make_engines(tiny_library, weights, **knobs)
    first = (jeng, JRequest) if writer == "jax" else (teng, TRequest)
    second = (teng, TRequest) if writer == "jax" else (jeng, JRequest)
    # the writer's engine fills the directory; the reader's engine,
    # opened only afterwards, must not have read it at construction
    second[0].cache.close()
    wrote = {r.uid: r for r in _run(*first, work)}
    first[0].cache.close()
    jeng, teng = make_engines(tiny_library, weights, **knobs)
    reader = teng if writer == "jax" else jeng
    served = {r.uid: r for r in _run(reader, second[1], work)}
    jeng.cache.close()
    teng.cache.close()
    assert dict(reader.stats.cache_tier_hits) == {"t2": 64}
    assert reader.stats.router_batches == 0
    for uid, r in served.items():
        w = wrote[uid]
        assert r.cached and (r.expert, r.cascade_depth) == (
            w.expert, w.cascade_depth), uid
        assert r.confidence == w.confidence
        np.testing.assert_array_equal(r.pred_losses, w.pred_losses)
