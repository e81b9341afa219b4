"""The port's experiment pipeline (``repro_torch.core``: ``qtable``,
``baselines``, ``pareto``, ``e2e``, ``experiment``) against the JAX
package's.

Q-tables of the same bridged library over the same batches: losses to
rtol = atol = 1e-5, accuracies exact.  Baselines and the Pareto sweep
over the same Q-table and predictions: identical.  ``cotrain`` for 2
steps from the same weights: history within 1e-4, weights within 1e-4
of each leaf's largest magnitude.  A tiny ``run_experiment`` on the CPU
completes with the reference's result keys.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import baselines as tbl
from repro_torch.core import e2e as te2e
from repro_torch.core import experiment as tex
from repro_torch.core import objective as tobj
from repro_torch.core import qtable as tqt
from repro_torch.core import router as trouter
from repro_torch.core.pareto import pareto_sweep as tpareto
from repro_torch.data.corpus import DomainCorpus as TCorpus

jax = pytest.importorskip("jax")

from repro.core import baselines as jbl  # noqa: E402
from repro.core import e2e as je2e  # noqa: E402
from repro.core import experiment as jex  # noqa: E402
from repro.core import objective as jobj  # noqa: E402
from repro.core import qtable as jqt  # noqa: E402
from repro.core.library import ModelLibrary  # noqa: E402
from repro.core.pareto import pareto_sweep as jpareto  # noqa: E402
from repro.core.router import RouterConfig, init_router  # noqa: E402
from repro.data.corpus import DomainCorpus as JCorpus  # noqa: E402

RC = RouterConfig(n_models=3, vocab_size=64, num_layers=1, d_model=32,
                  num_heads=2, d_ff=64)
# the reference's results.json keys (src/repro/core/experiment.py)
RESULT_KEYS = {"config", "library", "router_eps", "router_val_best",
               "router_stopped_early", "selection_accuracy",
               "aggregate_accuracy", "per_domain", "allocation",
               "silhouette", "pareto", "wall_s"}
POLICIES = {"tryage", "oracle", "random", "largest", "leaderboard",
            "keyword (gorilla-class)"}


@pytest.fixture(scope="module")
def setup(tiny_library):
    jc, tc = JCorpus(vocab_size=64, seed=0), TCorpus(vocab_size=64, seed=0)
    weights = {"github": 0.5, "books": 0.25, "pubmed": 0.25}
    jb = jex._eval_batches(jc, weights, 40, 24, seed=11, batch=16)
    tb = tex._eval_batches(tc, weights, 40, 24, seed=11, batch=16)
    for a, b in zip(jb, tb):
        assert all((a[k] == b[k]).all() for k in a)
    lib = bridge.library_from_jax(tiny_library, device="cpu")
    return jc, tc, jb, tb, lib


def test_build_q_table_matches_jax(tiny_library, setup):
    _, _, jb, tb, lib = setup
    want = jqt.build_q_table(tiny_library, jb)
    got = tqt.build_q_table(lib, tb)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(got["acc"], want["acc"])
    assert np.array_equal(got["domain"], want["domain"])
    choices = want["loss"].argmin(1)
    assert tqt.mlm_accuracy(got, choices) == jqt.mlm_accuracy(want, choices)


def test_baselines_and_pareto_match_jax(tiny_library, setup):
    jc, tc, jb, _, lib = setup
    q = jqt.build_q_table(tiny_library, jb)
    toks = np.concatenate([b["tokens"] for b in jb])
    N, M = len(toks), len(lib)
    pred = q["loss"] + np.random.default_rng(0).normal(
        0, 0.05, q["loss"].shape).astype(np.float32)
    pairs = [
        (jbl.oracle_choices(q), tbl.oracle_choices(q)),
        (jbl.random_router(N, M, 3), tbl.random_router(N, M, 3)),
        (jbl.largest_router(tiny_library, N), tbl.largest_router(lib, N)),
        (jbl.leaderboard_router(q, N), tbl.leaderboard_router(q, N)),
        (jbl.keyword_router(toks, jc, tiny_library),
         tbl.keyword_router(toks, tc, lib)),
    ]
    for want, got in pairs:
        assert np.array_equal(got, want)
        for tol in (0.0, 0.5):
            assert (tbl.selection_accuracy(got, q, tol)
                    == jbl.selection_accuracy(want, q, tol))
    want = jpareto(pred, q, tiny_library,
                   jobj.size_constraint(tiny_library))
    got = tpareto(pred, q, lib, tobj.size_constraint(lib))
    assert got == want


def _jax_library(tiny_library):
    """A copy of the shared fixture that cotrain may retrain."""
    return ModelLibrary([copy.copy(e) for e in tiny_library.experts])


def _close_leaves(got: dict, want: dict, rel=1e-4):
    assert sorted(got) == sorted(want)
    for n in want:
        w, g = np.asarray(want[n], np.float64), np.asarray(got[n],
                                                          np.float64)
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-12), n


def test_cotrain_matches_jax(tiny_library):
    jlib = _jax_library(tiny_library)
    tlib = bridge.library_from_jax(jlib, device="cpu")
    rp, _ = init_router(jax.random.PRNGKey(5), RC)
    router = bridge.router_from_jax(rp, trouter.RouterConfig(**vars(RC)),
                                    device="cpu")
    kw = dict(steps=2, batch=12, seq=24, seed=1, router_lr=1e-3)
    jst = je2e.cotrain(jlib, rp, RC, JCorpus(vocab_size=64, seed=0), **kw)
    tst = te2e.cotrain(tlib, router, trouter.RouterConfig(**vars(RC)),
                       TCorpus(vocab_size=64, seed=0), **kw)
    assert len(tst.history) == len(jst.history) == 2
    for a, b in zip(jst.history, tst.history):
        assert b["step"] == a["step"]
        for k in ("router_loss", "routed_loss", "oracle_loss"):
            assert abs(b[k] - a[k]) <= 1e-4, k
    _close_leaves({n: p.detach().numpy() for n, p in
                   tst.router_params.named_parameters()},
                  bridge.router_state(jst.router_params))
    for je, te in zip(jlib.experts, tlib.experts):
        _close_leaves({n: p.detach().numpy() for n, p in
                       te.params.named_parameters()},
                      bridge.model_state(je.params))


def test_tiny_run_experiment_completes_on_the_cpu():
    torch.manual_seed(0)
    xc = tex.ExperimentConfig(expert_steps=2, n_train_prompts=64,
                              n_val_prompts=32, n_test_per_domain=4,
                              router_epochs=1, seq=32)
    timings = {}
    res = tex.run_experiment(xc, verbose=False, save=False, device="cpu",
                             timings=timings)
    assert set(res) == RESULT_KEYS
    assert set(res["selection_accuracy"]) == POLICIES
    assert set(res["aggregate_accuracy"]) == POLICIES
    assert res["selection_accuracy"]["oracle"] == 1.0
    assert len(res["library"]) == 11
    assert np.isfinite(res["router_eps"])
    assert len(res["pareto"]["rows"]) == 23
    assert set(timings) == {"experts", "qtables", "router", "evaluate",
                            "expert_logs", "router_log"}
    assert [len(log.train_loss) for log in timings["expert_logs"]] == [2] * 11
    assert tex.ART_DIR.endswith("experiments/tryage_torch")
