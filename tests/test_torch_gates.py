"""The port's gated serving benches (``repro_torch.launch.gates``)
against the JAX package's ``benchmarks/run.py`` on the same weights,
carried across by ``repro_torch.bridge``.

* ``slo``: the reference's ``bench_slo`` (its CSV under a temporary
  ``ART_DIR``) and the port's on the same weights: every row equal, p99
  included, and the per-window timeline equal to the reference's CSV.
* ``cascade``: the reference's ``bench_cascade`` on a tiny artifact set
  (``tiny_library``, a router with an uncertainty head, a vocabulary-64
  corpus) and the port's: every accuracy, mean size, threshold,
  escalation count and depth histogram equal, except at operating
  points where some request's constrained scores lie within 1e-5 of
  each other or a confidence the escalation walk compares within 1e-5
  of the threshold (the ``PERF.md`` section 2 rule).  Untrained experts
  need not dominate, so either gate's refusal is caught, and with every
  row equal the two verdicts must agree.
* ``decision_latency``: at batches 256 and 512 the fused and staged
  paths' choices and depths are bit-identical to each other and to the
  JAX engine's ``_route_admitted``; the gates read off wall time run on
  the card only.
* ``mesh``: over CPU slots at sizes 1, 2, 4 and 8 the choices are
  identical across sizes and equal to the JAX engine's, each size's
  streams account every served token, and the makespan is the busiest
  stream's busy time.
"""

import csv
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import objective as tobj
from repro_torch.core import router as trouter
from repro_torch.data.batching import mlm_batch
from repro_torch.data.corpus import DomainCorpus as TCorpus
from repro_torch.launch import gates
from repro_torch.serving import Request as TRequest
from repro_torch.serving import TryageEngine as TEngine
from repro_torch.serving import lambda_matrix
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")

from repro.core import experiment as jex  # noqa: E402
from repro.core.library import ExpertSpec, ModelLibrary  # noqa: E402
from repro.core.objective import recency_constraint, size_constraint  # noqa: E402
from repro.core.router import RouterConfig, init_router  # noqa: E402
from repro.data.corpus import DomainCorpus as JCorpus  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import TryageEngine as JEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GAP = 1e-5
RC = RouterConfig(n_models=3, vocab_size=64, num_layers=1, d_model=32,
                  num_heads=2, d_ff=64)


@pytest.fixture(scope="module")
def bench():
    """``benchmarks/run.py``, loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        "reference_benchmarks", ROOT / "benchmarks" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_router(rp, rc):
    port_rc = trouter.RouterConfig(**vars(rc))
    return bridge.router_from_jax(rp, port_rc, device="cpu"), port_rc


def collect(gen, refusal=None):
    """The rows a bench yields; a gate refusal whose text holds
    ``refusal`` ends the list instead of raising (returned beside)."""
    rows, refused = [], None
    try:
        for row in gen:
            rows.append(row)
    except RuntimeError as e:
        if refusal is None or refusal not in str(e):
            raise
        refused = str(e)
    return rows, refused


# ----------------------------------------------------------------- slo

def test_slo_rows_equal_the_reference(bench, tiny_library, tmp_path,
                                      monkeypatch):
    monkeypatch.setattr(jex, "ART_DIR", str(tmp_path))
    ref = {name: (value, derived)
           for name, value, derived in bench.bench_slo(None)}
    csv_path = ref.pop("slo/timeline_csv")[1]
    # bench_slo's weights: tiny_library's experts and PRNGKey(9)'s router
    router, rc = port_router(init_router(jax.random.PRNGKey(9), RC)[0], RC)
    timeline = []
    got = {name: (value, derived) for name, value, derived in gates.slo(
        bridge.library_from_jax(tiny_library, device="cpu"), router, rc,
        device="cpu", table=timeline)}
    assert got == ref
    with open(csv_path) as f:
        want = list(csv.DictReader(f))
    assert [{k: (str(v) if k == "window" else f"{v:.6g}")
             for k, v in row.items()} for row in timeline] == want


# ------------------------------------------------------------- cascade

def cascade_near_ties(router, rc, lib, corpus, rows) -> set:
    """The operating points (row-name prefixes) at which some request of
    the cascade workload is within GAP of a tie: two constrained scores,
    or a confidence and the point's threshold."""
    rng = np.random.default_rng(0)
    toks, _ = corpus.sample_mixture({d: 1.0 / 8 for d in corpus.tables},
                                    256, 128, rng)
    tokens = torch.from_numpy(mlm_batch(toks, rng, 0.15, 64)["tokens"])
    with torch.inference_mode():
        pred = trouter.predict_losses(router, rc, {"tokens": tokens}).numpy()
        conf = tobj.confidence_scores(trouter.predict_uncertainty(
            router, rc, {"tokens": tokens}).numpy())
    cons = [tobj.size_constraint(lib), tobj.recency_constraint(lib)]
    cmat = tobj.constraint_matrix(cons, len(lib))
    order = tobj.escalation_order(lib)

    def tied(extra, q=None):
        reqs = []
        for i in range(256):
            lam = dict(gates.FLAG_MIX[i % 4])
            lam["size"] = lam.get("size", 0.0) + extra
            reqs.append(TRequest(uid=i, tokens=None, lambdas=lam))
        scores = pred + lambda_matrix(reqs, [c.name for c in cons]) @ cmat
        if (np.diff(np.sort(scores, axis=1), axis=1) < GAP).any():
            return True
        if q is None:
            return False
        # the point's threshold, then the confidences the escalation
        # walk compares with it
        first = scores.argmin(axis=1)
        thr = np.quantile(conf[np.arange(256), first], q) + 1e-6
        for i in range(256):
            pos, depth = order.index(int(scores[i].argmin())), 0
            while True:
                if abs(conf[i, order[pos]] - thr) < GAP:
                    return True
                if (conf[i, order[pos]] >= thr or pos + 1 == len(order)
                        or depth == 3):
                    break
                rest = order[pos + 1:]
                pos += 1 + int(np.argmin(scores[i, rest]))
                depth += 1
        return False

    out = set()
    for name, _, _ in rows:
        parts = name.split("/")
        if parts[1] == "single_shot" and tied(float(parts[2][4:])):
            out.add("/".join(parts[:3]))
        if parts[1] == "cascade" and parts[3] == "accuracy" and tied(
                8.0, int(parts[2][1:]) / 100):
            out.add("/".join(parts[:3]))
    return out


def test_cascade_rows_equal_the_reference(bench, tiny_library,
                                          monkeypatch):
    rp, _ = init_router(jax.random.PRNGKey(9), RC, uncertainty=True)
    art = {"library": tiny_library, "router_params": rp, "rc": RC,
           "corpus": JCorpus(vocab_size=64, seed=0)}
    monkeypatch.setattr(jex, "load_artifacts", lambda: art)
    refusal = "does not dominate"
    ref, ref_refused = collect(
        bench.bench_cascade({"config": {"expert_steps": 60}}), refusal)
    router, rc = port_router(rp, RC)
    lib = bridge.library_from_jax(tiny_library, device="cpu")
    corpus = TCorpus(vocab_size=64, seed=0)
    got, got_refused = collect(
        gates.cascade(lib, router, rc, corpus, expert_steps=60,
                      device="cpu"), refusal)
    assert [r[0] for r in got] == [r[0] for r in ref]
    differ = [name for (name, *row), (_, *rrow) in zip(got, ref)
              if row != rrow]
    if differ:
        # only at a near tie, and then the verdict may differ too
        excused = cascade_near_ties(router, rc, lib, corpus, got)
        assert all(n.rsplit("/", 1)[0] in excused
                   or n == "cascade/dominates_single_shot"
                   for n in differ), (differ, excused)
    else:
        assert got_refused == ref_refused


def test_cascade_refuses_an_undertrained_library():
    rows, refused = collect(gates.cascade(None, None, None, None,
                                          expert_steps=8), "expert_steps=8")
    assert rows == [] and f"< {gates.MIN_EXPERT_STEPS}" in refused


# ---------------------------------------------------- decision_latency

@pytest.fixture(scope="module")
def unc_weights(tiny_library):
    """bench_decision_latency's weights: tiny_library's experts and
    PRNGKey(9)'s router with an uncertainty head, in both packages."""
    rp, _ = init_router(jax.random.PRNGKey(9), RC, uncertainty=True)
    router, rc = port_router(rp, RC)
    return rp, router, rc, bridge.library_from_jax(tiny_library, device="cpu")


def test_decision_latency_rows_hold_on_the_cpu(unc_weights):
    _, router, rc, lib = unc_weights
    table = []
    rows = {name: (value, derived) for name, value, derived in
            gates.decision_latency(lib, router, rc, device="cpu",
                                   batches=(256, 512), repeats=1,
                                   timing_gates=False, table=table)}
    for B in (256, 512):
        assert rows[f"decision_latency/b{B}/choice_match"][0] == 1.0
        assert rows[f"decision_latency/b{B}/tuned_tile_speedup"] == (
            1.0, "effective k_groups 16; no distinct candidate pair")
        esc = float(rows[f"decision_latency/staged/b{B}/p50_ms"][1]
                    .split("esc_frac=")[1])
        assert 0.0 < esc < 0.5
    assert [(r["batch"], r["path"]) for r in table] == [
        (256, "staged"), (256, "fused"), (512, "staged"), (512, "fused")]


def test_decision_latency_decides_as_the_jax_engine(tiny_library,
                                                    unc_weights):
    rp, router, rc, lib = unc_weights
    knobs = dict(decision_cache=False, cascade_max_depth=2)
    staged, fused = (TEngine(lib, router, rc, fused_cascade=f,
                             device="cpu", **knobs) for f in (False, True))
    jeng = JEngine(tiny_library, rp, RC, use_kernel=True, **knobs)
    rng = np.random.default_rng(0)
    thr = gates.median_confidence(staged, gates.latency_probe(rng))
    for B in (256, 512):
        reqs = gates.latency_workload(rng, B, thr)
        jreqs = [JRequest(uid=r.uid, tokens=r.tokens,
                          min_confidence=r.min_confidence) for r in reqs]
        want = jeng._route_admitted(jreqs)
        for eng in (staged, fused):
            got = eng._route_admitted(reqs)
            assert np.array_equal(got[1], want[1]), B
            assert np.array_equal(got[3], want[3]), B
        assert 0 < (want[3] > 0).sum() < B // 2


# ---------------------------------------------------------------- mesh

def test_mesh_choices_equal_across_sizes_and_the_jax_engine():
    lib = gates.mesh_library(device="cpu")
    rc8 = RouterConfig(n_models=8, vocab_size=64, num_layers=1, d_model=32,
                       num_heads=2, d_ff=64)
    rp, _ = init_router(jax.random.PRNGKey(9), rc8)
    router, rc = port_router(rp, rc8)
    table = []
    rows = {name: value for name, value, _ in gates.mesh(
        lib, router, rc, ["cpu"] * 8, timing_gates=False, table=table)}
    assert rows["mesh/choice_match"] == 1.0
    assert [r["mesh_size"] for r in table] == [1, 2, 4, 8]
    assert [r["streams"] for r in table] == [1, 2, 4, 8]
    for r in table:
        assert r["tokens"] == sum(r["stream_tokens"]) == 256 * 64
        assert r["makespan_s"] == max(r["busy_s"])
        assert rows[f"mesh/size{r['mesh_size']}_makespan_s"] == max(
            r["busy_s"])
        if r["mesh_size"] > 1:
            assert sum(t > 0 for t in r["stream_tokens"]) > 1
    # the JAX engine's decisions on the same workload, 32 rows a batch;
    # deciding reads no expert's weights, only the sizes the size
    # constraint takes
    jlib = ModelLibrary([ExpertSpec(e.name, None, {}, e.recency,
                                    n_params=e.n_params)
                         for e in lib.experts])
    jeng = JEngine(jlib, rp, rc8, [size_constraint(jlib),
                                   recency_constraint(jlib)],
                   max_batch=32, use_kernel=True, decision_cache=False)
    toks = np.random.default_rng(0).integers(4, 64, size=(256, 64)).astype(
        np.int32)
    jreqs = [JRequest(uid=i, tokens=toks[i],
                      lambdas=gates.FLAG_MIX[i % 4]) for i in range(256)]
    want = np.concatenate([jeng._score_batch(jreqs[i:i + 32])[1]
                           for i in range(0, 256, 32)])
    assert table[0]["choices"] == [f"e{int(c)}" for c in want]
