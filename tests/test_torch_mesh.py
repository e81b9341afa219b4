"""Mesh serving of the port (``launch.mesh``, the engine's mesh path)
against the meshless port engine and the JAX package's engine.

The load-bearing contract is the reference's (``tests/test_mesh.py``):
a ``(1, 1)`` mesh engine is **bit for bit** the meshless engine —
identical ``Result``s (the bytes of ``pred_losses`` and ``predictions``
included) and identical ``EngineStats`` summaries — under ``serve()``
with cascade escalations and health-fallback reroutes, and under
``run()``.  Against the JAX ``(1, 1)`` engine (``make_host_mesh(1, 1)``
runs on one CPU device): choices, depths, flush order and latencies
identical, floats within ``torch_serving_util``'s 1e-5, and
``mesh_summary()`` identical in mesh, placement and each stream's
flushes, tokens and failures (busy seconds are wall time).

Multi-device meshes run over explicit CPU slots (``devices=["cpu"] *
8``), the port's counterpart of the reference's 8 virtual XLA devices:
a ``(2, 4)`` mesh decides as the meshless engine, a choice excused only
where the meshless row's top-two constrained-score gap is under 1e-5
(the ``data`` blocks run the encoder on fewer rows, so GEMMs may round
otherwise), NLL within rtol 1e-5 (the reference test's tolerance).
Each engine reads its own clock that only the test advances.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import objective as tobj
from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.serving import ExpertHealth as TExpertHealth
from repro_torch.serving import Request as TRequest
from repro_torch.serving import TryageEngine as TEngine
from repro_torch.serving.placement import plan_placement
from torch_serving_util import (Clock, assert_same_results,
                                assert_same_stats, make_weights)
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")

from repro.core.objective import recency_constraint, size_constraint  # noqa: E402
from repro.data.batching import mlm_batch  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro.serving import ExpertHealth as JExpertHealth  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import TryageEngine as JEngine  # noqa: E402

from test_torch_engine import RC  # noqa: E402

GAP = 1e-5        # a choice may differ only below this top-two gap
NLL_RTOL = 1e-5


def cpu_mesh(data, model):
    return make_host_mesh(data, model, devices=["cpu"] * (data * model))


@pytest.fixture(scope="module")
def weights(tiny_library):
    return make_weights(tiny_library)


def _work(n, seed=0, min_confidence=0.0, n_unique=None):
    """``tests/test_mesh.py:_requests`` as plain field dicts."""
    n_unique = n if n_unique is None else n_unique
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 64, size=(n_unique, 32)).astype(np.int32)
    mb = mlm_batch(toks, rng, 0.2, 64)
    mix = [{}, {"size": 1.0}, {"size": 8.0}, {"recency": 2.0}]
    conf = (min_confidence if callable(min_confidence)
            else (lambda i: min_confidence))
    return [dict(uid=i, tokens=mb["tokens"][i % n_unique],
                 targets=mb["targets"][i % n_unique],
                 mask=mb["mask"][i % n_unique], lambdas=mix[i % len(mix)],
                 min_confidence=conf(i))
            for i in range(n)]


def _engine(weights, clock, **kw):
    _, router, rc, lib = weights
    kw.setdefault("max_batch", 32)
    return TEngine(lib, router, rc,
                   [tobj.size_constraint(lib), tobj.recency_constraint(lib)],
                   now_fn=clock, device="cpu", **kw)


def _result_key(r):
    d = dataclasses.asdict(r)
    d["pred_losses"] = d["pred_losses"].tobytes()
    d["predictions"] = d["predictions"].tobytes()
    return d


def _hot_expert(weights, work):
    """Post-cascade traffic argmax, from a throwaway scout engine so the
    engines under test keep pristine stats."""
    scout = _engine(weights, Clock())
    reqs = [TRequest(**w) for w in work]
    pred, choice = scout._score_batch(reqs)
    choice, _, _ = scout._cascade(reqs, pred, choice)
    return int(np.bincount(np.asarray(choice), minlength=3).argmax())


def _serve(eng, clock, work, inject=None, count=None):
    def stream():
        for i, w in enumerate(work):
            if i == 0 and inject is not None:
                eng.scheduler.inject_failures(
                    inject, **({} if count is None else {"count": count}))
            clock.advance(0.001)
            yield TRequest(**w)

    return sorted(eng.serve(stream()), key=lambda r: r.uid)


def _near_tie(result, lambdas, cmat, cnames):
    lam = np.array([lambdas.get(c, 0.0) for c in cnames])
    sc = np.sort(result.pred_losses + lam @ cmat)
    return sc[1] - sc[0] < GAP


def _assert_decides_as(ref, got, eng, work):
    """The reference test's assertions, a choice excused at a near tie
    of the meshless row."""
    assert [r.uid for r in got] == [r.uid for r in ref]
    for a, b in zip(ref, got):
        if (a.expert, a.cascade_depth) != (b.expert, b.cascade_depth):
            assert _near_tie(a, work[a.uid]["lambdas"], eng._cmat,
                             eng._cnames), a.uid
            continue
        assert a.fallback_depth == b.fallback_depth, a.uid
        if a.loss is not None or b.loss is not None:
            np.testing.assert_allclose(b.loss, a.loss, rtol=NLL_RTOL)


# ------------------------------------------------------------ the mesh


def test_make_host_mesh_errors():
    with pytest.raises(ValueError, match="needs 8 devices but only 1 is "
                                         "visible") as err:
        make_host_mesh(2, 4, platform="cpu")
    assert "devices=" in str(err.value)           # says how to simulate
    n_cards = torch.cuda.device_count()
    if n_cards < 4096:
        with pytest.raises(ValueError, match="needs 4096 devices"):
            make_host_mesh(64, 64)
    with pytest.raises(ValueError, match=">= 1"):
        make_host_mesh(0, 1, platform="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_host_mesh(1, -2, devices=["cpu"])
    with pytest.raises(ValueError, match="needs 8 devices, got 7"):
        make_host_mesh(2, 4, devices=["cpu"] * 7)
    with pytest.raises(ValueError, match="no mesh over platform"):
        make_host_mesh(1, 1, platform="tpu")
    if n_cards < 256:
        with pytest.raises(ValueError, match="needs 256 devices"):
            make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True)


def test_mesh_over_explicit_and_visible_devices():
    m = cpu_mesh(2, 4)
    assert m.shape == {"data": 2, "model": 4}
    assert m.axis_names == ("data", "model")
    assert m.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    one = make_host_mesh(1, 1, platform="cpu")
    assert one.shape == {"data": 1, "model": 1}
    assert one.devices[0, 0] == torch.device("cpu")
    # the same shape mapping as the reference's mesh
    assert dict(jax_host_mesh(1, 1).shape) == one.shape
    with pytest.raises(ValueError, match="axes"):
        Mesh(np.array([torch.device("cpu")], dtype=object), ("data", "model"))


# ------------------------------------------------------ engine refusals


def test_engine_rejects_mesh_without_serving_axes(weights):
    mesh = Mesh(np.array([torch.device("cpu")], dtype=object), ("x",))
    with pytest.raises(ValueError, match="data"):
        _engine(weights, Clock(), mesh=mesh)


def test_engine_rejects_mismatched_placement(weights):
    mesh = cpu_mesh(1, 1)
    with pytest.raises(ValueError, match="model axis is 1"):
        _engine(weights, Clock(), mesh=mesh,
                placement=plan_placement([1.0, 1.0, 1.0], n_slices=2))
    with pytest.raises(ValueError, match="different library"):
        _engine(weights, Clock(), mesh=mesh,
                placement=plan_placement([1.0, 1.0], n_slices=1))


def test_engine_rejects_a_foreign_first_device(weights):
    # the mesh's first device must be the engine's: the unsharded
    # router passes run there
    mesh = make_host_mesh(1, 2, devices=["meta", "cpu"])
    with pytest.raises(ValueError, match="first device is meta"):
        _engine(weights, Clock(), mesh=mesh)


def test_replicas_on_another_device_are_copies(weights):
    _, router, _, lib = weights
    with torch.inference_mode():
        same = TEngine._replica(router, torch.device("cpu"))
        meta = TEngine._replica(lib[0].params, torch.device("meta"))
    assert same is router
    assert meta is not lib[0].params
    params = list(meta.parameters())
    assert params and all(p.device.type == "meta" and not p.is_inference()
                          for p in params)


# ------------------------------------------------- (1, 1) = meshless


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_1x1_mesh_engine_is_bit_for_bit_meshless_serve(weights, fused):
    """The acceptance gate: a (1, 1)-mesh engine serving the mixed-flag
    workload — cascade escalations AND injected flush failures driving
    health-fallback reroutes — gives identical Results and identical
    EngineStats to the meshless engine."""
    work = _work(96, seed=7, min_confidence=0.99, n_unique=64)
    hot = _hot_expert(weights, work)
    outs, stats, engines = [], [], []
    for mesh in (None, cpu_mesh(1, 1)):
        clock = Clock()
        eng = _engine(weights, clock, lane_target=8, max_wait_s=1e9,
                      fused_cascade=fused,
                      health=TExpertHealth(3, now_fn=clock),
                      mesh=mesh, replicate_hot=1)
        out = _serve(eng, clock, work, inject=hot, count=2)
        assert len(out) == 96
        outs.append(out)
        stats.append(eng.stats.summary())
        engines.append(eng)
    for a, b in zip(*outs):
        assert _result_key(a) == _result_key(b)
    assert stats[0] == stats[1]
    assert stats[0]["cascade"]["escalations"] > 0
    assert stats[0]["fallback"]["reroutes"] > 0
    assert engines[0].mesh_summary() is None
    ms = engines[1].mesh_summary()
    assert ms["mesh"] == {"data": 1, "model": 1}
    assert ms["streams"]["streams"] == 1
    assert ms["streams"]["flushes"] == [sum(stats[1]["flushes"].values())]
    assert ms["streams"]["failures"] == [2]
    assert ms["placement"]["replicated"] == []      # one slice


def test_1x1_mesh_engine_is_bit_for_bit_meshless_run(weights):
    work = _work(96, seed=3, min_confidence=lambda i: 0.6 * (i % 2),
                 n_unique=80)
    outs, stats, engines = [], [], []
    for mesh in (None, cpu_mesh(1, 1)):
        eng = _engine(weights, Clock(), fused_cascade=True, mesh=mesh)
        for w in work:
            eng.submit(TRequest(**w))
        outs.append(sorted(eng.run(), key=lambda r: r.uid))
        stats.append(eng.stats.summary())
        engines.append(eng)
    for a, b in zip(*outs):
        assert _result_key(a) == _result_key(b)
    assert stats[0] == stats[1]
    assert stats[0]["cascade"]["escalations"] > 0
    st = engines[1].mesh_summary()["streams"]
    assert st["flushes"] == [stats[1]["flushes"]["fifo"]]
    assert st["tokens"] == [96 * 32]


def test_1x1_mesh_engine_matches_jax(tiny_library, weights):
    """The port's (1, 1) engine against the JAX (1, 1) engine under
    serve() with escalations and injected failures: the same Results
    (decisions exact, floats within 1e-5), counters and mesh
    telemetry."""
    work = _work(96, seed=7, min_confidence=0.99, n_unique=64)
    hot = _hot_expert(weights, work)
    rp = weights[0]
    knobs = dict(max_batch=32, lane_target=8, max_wait_s=1e9,
                 fused_cascade=True, replicate_hot=1)
    jclock, tclock = Clock(), Clock()
    jeng = JEngine(tiny_library, rp, RC,
                   [size_constraint(tiny_library),
                    recency_constraint(tiny_library)],
                   use_kernel=True, now_fn=jclock,
                   health=JExpertHealth(3, now_fn=jclock),
                   mesh=jax_host_mesh(1, 1), **knobs)
    teng = _engine(weights, tclock, health=TExpertHealth(3, now_fn=tclock),
                   mesh=make_host_mesh(1, 1, platform="cpu"), **knobs)
    outs = []
    for eng, clock, req in ((jeng, jclock, JRequest),
                            (teng, tclock, TRequest)):
        def stream(eng=eng, clock=clock, req=req):
            for i, w in enumerate(work):
                if i == 0:
                    eng.scheduler.inject_failures(hot, count=2)
                clock.advance(0.001)
                yield req(**w)
        outs.append(list(eng.serve(stream())))
    assert_same_results(*outs)
    assert_same_stats(jeng, teng)
    assert teng.stats.escalations > 0 and teng.stats.reroutes > 0
    ref, got = jeng.mesh_summary(), teng.mesh_summary()
    assert got["mesh"] == dict(ref["mesh"])
    assert got["placement"] == ref["placement"]
    for key in ("streams", "flushes", "tokens", "failures"):
        assert got["streams"][key] == ref["streams"][key], key


def test_warm_mesh_runs_every_variant(weights):
    """warm_mesh covers the full (expert, replica stream, bucket size)
    grid and is a no-op on a meshless engine; warming charges no stream
    time."""
    assert _engine(weights, Clock()).warm_mesh(32) == 0
    eng = _engine(weights, Clock(), lane_target=8, mesh=cpu_mesh(1, 1),
                  replicate_hot=1)
    # 3 experts x 1 device x buckets {1, 2, 4, 8}
    assert eng.warm_mesh(32) == 12
    assert eng.streams.summary()["flushes"] == [0]
    assert eng.streams.makespan_s == 0.0
    wide = _engine(weights, Clock(), lane_target=8, mesh=cpu_mesh(2, 4),
                   replicate_hot=1)
    # the hot expert on all 4 slices x 2 rows, the others on 2 streams
    assert sorted(len(s) for s in wide._expert_streams.values()) == [2, 2, 8]
    assert wide.warm_mesh(32, bucket_sizes=[1, 8]) == 12 * 2
    assert len(wide._expert_params_on) == 12
    assert sum(wide.streams.summary()["flushes"]) == 0


# --------------------------------------------------- multi-slot meshes


class _Calls:
    """Counts the calls (and row counts) of a kernel wrapper."""

    def __init__(self, monkeypatch, module, name):
        inner, self.rows = getattr(module, name), []

        def counted(x, *args, **kwargs):
            self.rows.append(x.shape[0])
            return inner(x, *args, **kwargs)

        monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_2x4_mesh_matches_meshless(weights, monkeypatch, fused):
    """On 8 CPU slots a (2, 4) mesh — data-parallel routing, experts
    spread over 4 slices with the hottest replicated — decides as the
    meshless engine, with NLL within rtol 1e-5."""
    # every third request asks for confidence 0.99 (over every flag of
    # the mix, so some first picks have a larger expert to escalate to)
    work = _work(128, seed=11, n_unique=96,
                 min_confidence=lambda i: 0.99 if i % 3 == 0 else 0.0)
    outs, engines = [], []
    for mesh in (None, cpu_mesh(2, 4)):
        clock = Clock()
        eng = _engine(weights, clock, lane_target=8, max_wait_s=1e9,
                      fused_cascade=fused, mesh=mesh, replicate_hot=1)
        if mesh is not None:
            score = _Calls(monkeypatch, rs_ops, "router_route")
            cascade = _Calls(monkeypatch, rc_ops, "router_route_cascade")
        out = _serve(eng, clock, work)
        assert len(out) == 128
        outs.append(out)
        engines.append(eng)
    base, eng = engines
    _assert_decides_as(*outs, base, work)
    st = eng.mesh_summary()["streams"]
    assert sum(st["flushes"]) == sum(eng.stats.flushes.values())
    assert sum(1 for f in st["flushes"] if f > 0) > 1
    assert eng.placement.n_slices == 4
    assert len(eng.stats.per_expert) > 1
    assert eng.stats.escalations > 0
    # two data blocks of equal rows per router batch; no fused cascade
    assert len(score.rows) == 2 * eng.stats.router_batches
    assert len(set(score.rows)) == 1 and score.rows[0] == 16
    assert cascade.rows == []
    assert set(eng.stats.router_tiles["router_score"]) == {32}


def test_mesh_fallback_parity(weights):
    """Failure injection (reroutes via health fallback) routes alike on
    the (2, 4) mesh, and the failed flushes are charged to the failing
    expert's streams."""
    work = _work(64, seed=5)
    hot = _hot_expert(weights, work)
    hot_name = weights[3][hot].name
    outs, engines = [], []
    for mesh in (None, cpu_mesh(2, 4)):
        clock = Clock()
        eng = _engine(weights, clock, lane_target=8, max_wait_s=1e9,
                      health=TExpertHealth(3, now_fn=clock), mesh=mesh,
                      replicate_hot=1)
        out = _serve(eng, clock, work, inject=hot)   # fail every flush
        assert len(out) == 64
        assert all(not r.failed and r.expert != hot_name for r in out)
        outs.append(out)
        engines.append(eng)
    base, eng = engines
    _assert_decides_as(*outs, base, work)
    st = eng.mesh_summary()["streams"]
    mine = set(eng._expert_streams[hot])
    n_failed = eng.stats.expert_failures[hot_name]
    assert n_failed >= 1
    assert sum(f for i, f in enumerate(st["failures"]) if i in mine) \
        == n_failed
    assert all(f == 0 for i, f in enumerate(st["failures"])
               if i not in mine)


def test_data_axis_pads_the_decision_batch(weights, monkeypatch):
    """A (3, 1) mesh pads each decision batch to a multiple of 3 past
    its bucket (32 -> 33, a tail of 5 -> 8 -> 9) and decides as the
    meshless engine."""
    work = _work(69, seed=2)
    outs, engines = [], []
    for mesh in (None, cpu_mesh(3, 1)):
        eng = _engine(weights, Clock(), mesh=mesh)
        if mesh is not None:
            score = _Calls(monkeypatch, rs_ops, "router_route")
        for w in work:
            eng.submit(TRequest(**w))
        outs.append(sorted(eng.run(), key=lambda r: r.uid))
        engines.append(eng)
    base, eng = engines
    _assert_decides_as(*outs, base, work)
    assert score.rows == [11] * 6 + [3] * 3
    assert sorted(eng.stats.router_tiles["router_score"]) == [9, 33]
    assert eng.stats.padded_rows == base.stats.padded_rows


def test_adapting_engine_on_a_2x1_mesh(weights):
    """Online adaptation on a (2, 1) mesh: every swap reaches the data
    replicas (rebuilt when the version moves) and the engine decides as
    the meshless adapting engine."""
    work = _work(128, seed=4, n_unique=96)
    outs, engines = [], []
    for mesh in (None, cpu_mesh(2, 1)):
        clock = Clock()
        eng = _engine(weights, clock, lane_target=8, max_wait_s=1e9,
                      adapt_every=16, adapt_batch=8, adapt_lr=0.05,
                      mesh=mesh)
        outs.append(_serve(eng, clock, work))
        engines.append(eng)
    base, eng = engines
    assert eng.router_version == base.router_version > 1
    # swaps after the last decision leave the replicas stale until the
    # next one asks for them
    stale = eng._mesh_rp_cache[0]
    assert 0 < stale <= eng.router_version
    replicas = eng._mesh_router_params()
    assert eng._mesh_rp_cache[0] == eng.router_version
    assert len(replicas) == 2
    assert all(r is eng.router_params for r in replicas)
    _assert_decides_as(*outs, base, work)
    assert base.stats.adapt_updates == eng.stats.adapt_updates > 1
