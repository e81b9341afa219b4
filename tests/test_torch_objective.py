"""The port's routing objective (``repro_torch.core.objective``: ``route``,
``routing_scores`` with the uncertainty penalty, ``log_size_constraint``)
against the JAX package's on seeded numpy losses.

The losses are float32, the type the reference's ``jnp`` arrays take, so
both packages add the same f32 values; the chosen experts must be
identical and the constraint values within 1e-7.  The tie cases use
losses on a coarse grid and constraint weights whose products are exact,
so both sides see exact ties and must pick the lower index.
"""

import numpy as np
import pytest

from repro_torch.core import library as tlib
from repro_torch.core import objective as tobj
from torch_threads import one_torch_thread  # noqa: F401

pytest.importorskip("jax")

from repro.core import library as jlib  # noqa: E402
from repro.core import objective as jobj  # noqa: E402

CONSTRAINT_TOL = 1e-7
SIZES = {
    "paper": None,       # the paper library's encoders, counted
    "spread": (4_400, 1_100_000, 52_000, 300_000_000, 7_000, 124_000_000,
               88_000, 88_000, 2, 16_000_000, 530),
    "equal": (1000,) * 11,
}


def _count(cfg) -> int:
    """An encoder's parameter count from its widths (embeddings, per
    layer attention, MLP and norms): a size per expert, as the library
    reads after training."""
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
    return V * d + L * (4 * d * d + 4 * d + 2 * d * f + f + d + 4 * d)


def _libraries(kind: str):
    """The paper library in both packages, with one size list."""
    j = jlib.ModelLibrary(jlib.paper_library_specs())
    t = tlib.ModelLibrary(tlib.paper_library_specs())
    sizes = SIZES[kind] or [_count(e.cfg) for e in t.experts]
    for lib in (j, t):
        for e, n in zip(lib.experts, sizes):
            e.n_params = int(n)
    return j, t


def _constraints(mod, lib, names):
    fns = {"size": mod.size_constraint, "log_size": mod.log_size_constraint,
           "recency": mod.recency_constraint}
    return [fns[n](lib) for n in names]


@pytest.mark.parametrize("kind", list(SIZES))
def test_log_size_constraint_matches_reference(kind):
    j, t = _libraries(kind)
    want, got = jobj.log_size_constraint(j), tobj.log_size_constraint(t)
    assert got.name == want.name == "log_size"
    assert got.values.shape == (11,)
    np.testing.assert_allclose(got.values, want.values, rtol=0,
                               atol=CONSTRAINT_TOL)


CASES = {
    # (constraint names, lambdas, with uncertainty, risk weight)
    "none": ((), (), False, 0.0),
    "size": (("size",), (0.7,), False, 0.0),
    "log_size+recency": (("log_size", "recency"), (1.3, 0.4), False, 0.0),
    "uncertainty": ((), (), True, 0.8),
    "uncertainty_off": (("size",), (0.2,), True, 0.0),
    "all": (("size", "log_size", "recency"), (0.5, 0.25, 2.0), True, 1.5),
}


@pytest.mark.parametrize("shape", [(11,), (64, 11), (4, 16, 11)])
@pytest.mark.parametrize("case", list(CASES))
def test_route_matches_reference(case, shape):
    names, lams, with_sigma, risk = CASES[case]
    j, t = _libraries("paper")
    rng = np.random.default_rng(len(shape) * 7 + len(names))
    pred = (rng.random(shape) * 4.0).astype(np.float32)
    sigma = (rng.random(shape).astype(np.float32) if with_sigma else None)
    want = np.asarray(jobj.route(pred, _constraints(jobj, j, names), lams,
                                 sigma, risk))
    got = tobj.route(pred, _constraints(tobj, t, names), lams, sigma, risk)
    assert got.shape == shape[:-1]
    np.testing.assert_array_equal(got, want)
    scores_w = np.asarray(jobj.routing_scores(
        pred, _constraints(jobj, j, names), lams, sigma, risk))
    scores_g = tobj.routing_scores(pred, _constraints(tobj, t, names), lams,
                                   sigma, risk)
    np.testing.assert_allclose(scores_g, scores_w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lam", [0.0, 0.5, 2.0])
def test_route_ties_go_to_the_lower_index(lam):
    """Losses on a grid of 1/4 and a size constraint on a grid of 1/8
    with lambda a power of two: every score is exact, many tie."""
    j, t = _libraries("paper")
    rng = np.random.default_rng(5)
    pred = (rng.integers(0, 3, (256, 11)) / 4).astype(np.float32)
    cvals = (np.arange(11) % 3) / 8
    want = np.asarray(jobj.route(pred, [jobj.Constraint("grid", cvals)],
                                 [lam]))
    got = tobj.route(pred, [tobj.Constraint("grid", cvals)], [lam])
    np.testing.assert_array_equal(got, want)
    scores = pred + np.float32(lam) * cvals.astype(np.float32)
    ties = (scores == scores.min(-1, keepdims=True)).sum(-1) > 1
    assert ties.sum() > 50
    np.testing.assert_array_equal(got, scores.argmin(-1))


def test_route_checks_lambdas_and_skips_zero_risk():
    t = tlib.ModelLibrary(tlib.paper_library_specs())
    for i, e in enumerate(t.experts):
        e.n_params = 100 * (i + 1)
    with pytest.raises(ValueError, match="lambdas"):
        tobj.route(np.zeros((2, 11), np.float32),
                   [tobj.size_constraint(t)], [])
    pred = np.linspace(1, 0, 11, dtype=np.float32)
    sigma = np.linspace(5, 0, 11, dtype=np.float32)
    assert int(tobj.route(pred, uncertainty=sigma)) == 10
    assert int(tobj.route(pred[::-1].copy(), uncertainty=sigma,
                          risk_weight=1.0)) == 10
