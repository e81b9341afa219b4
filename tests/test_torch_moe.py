"""The port's MoE MLP (``repro_torch.models.moe``) against
``repro.models.moe.apply_moe`` on the same weights (the JAX package's
``init_moe``, carried as numpy) and the same numpy inputs, for reduced
qwen2-moe-a2.7b (4 experts, all chosen, one shared expert) and reduced
grok-1-314b (4 experts, top 2):

* the output, the aux term and the chosen experts, at the config's
  capacity factor and at one small enough to drop pairs, where the port's
  drop set must equal the reference rule's (each expert keeps its first C
  pairs in (token, choice) order, on the reference's ``top_k`` choices);
* a zero router: equal probabilities pick experts 0..K-1 for every token,
  and aux is exactly 1;
* top-k = E against the dense sum over all experts weighted by the
  router's probabilities;
* ``lm_loss`` and its aux term against ``repro.models.model.lm_loss`` for
  the reduced grok model, with finite gradients in f32.

Tolerance: outputs within 1e-5 of the largest magnitude (f32 sums in
another order), aux within 1e-6, losses rtol 1e-5; chosen experts and
drop sets identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

REL = 1e-5
AUX_TOL = 1e-6
ARCHS = ["qwen2-moe-a2.7b", "grok-1-314b"]
B, S = 2, 12


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """(JAX config, port config, numpy params, JAX params, torch params,
    numpy input (B, S, d)) for one reduced config."""
    jcfg = jget_config(request.param).reduced(d_model=64)
    p, _ = jmoe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    pn = _tree_np(p)
    x = np.random.default_rng(2).normal(size=(B, S, jcfg.d_model))
    return (jcfg, bridge.model_config_from(jcfg), pn,
            jax.tree.map(jnp.asarray, pn), _tree_t(pn), x.astype(np.float32))


def _close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= REL * np.abs(want).max(), err


def _keep_rule(gate_idx, C):
    """The reference's drop rule from its choices: pair i (token i // K,
    choice i % K) is kept when fewer than C earlier pairs chose its
    expert."""
    flat = np.asarray(gate_idx).reshape(-1)
    seen, keep = {}, []
    for e in flat:
        keep.append(seen.get(e, 0) < C)
        seen[e] = seen.get(e, 0) + 1
    return np.array(keep)


def _run_both(setup, cf=None, router=None):
    jcfg, tcfg, _, jp, tp, x = setup
    if router is not None:
        jp = dict(jp, router=jnp.asarray(router))
        tp = dict(tp, router=torch.from_numpy(router))
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    xt = torch.from_numpy(x)
    ty, taux = tmoe.apply_moe(tp, xt, tcfg, capacity_factor=cf)
    r = tmoe.route(tp, xt.reshape(-1, tcfg.d_model), tcfg, cf)
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(-1, jcfg.d_model)
                            @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(jprobs, jcfg.moe.top_k)
    return (ty, taux, r), (jy, jaux, np.asarray(jidx))


@pytest.mark.parametrize("cf", [None, 0.25], ids=["config_cf", "drops"])
def test_apply_moe_matches_reference(setup, cf):
    (ty, taux, r), (jy, jaux, jidx) = _run_both(setup, cf)
    K = setup[0].moe.top_k
    assert ty.shape == (B, S, setup[0].d_model)
    np.testing.assert_array_equal(r.gate_idx.numpy(), jidx)
    want_keep = _keep_rule(jidx, r.capacity)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    assert r.capacity == max(K, int(np.ceil(
        B * S / setup[0].moe.num_experts
        * (cf or setup[0].moe.capacity_factor) * K)))
    if cf is not None:
        assert not want_keep.all()       # the case drops pairs
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL


def test_zero_router_picks_the_lowest_experts_and_aux_is_one(setup):
    jcfg = setup[0]
    E, K = jcfg.moe.num_experts, jcfg.moe.top_k
    zero = np.zeros((jcfg.d_model, E), np.float32)
    (ty, taux, r), (jy, jaux, jidx) = _run_both(setup, router=zero)
    want = np.broadcast_to(np.arange(K), (B * S, K))
    np.testing.assert_array_equal(r.gate_idx.numpy(), want)
    np.testing.assert_array_equal(jidx, want)
    _close(ty, jy)
    assert float(taux) == pytest.approx(1.0, abs=AUX_TOL)
    assert float(jaux) == pytest.approx(1.0, abs=AUX_TOL)


def test_top_k_of_all_experts_is_the_dense_mixture(setup):
    jcfg, tcfg, pn, _, _, x = setup
    E = jcfg.moe.num_experts
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             top_k=E))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             top_k=E))
    setup = (jcfg, tcfg) + setup[2:]
    (ty, _, r), (jy, _, _) = _run_both(setup)
    assert bool(r.keep.all())
    xt = torch.from_numpy(x).reshape(-1, jcfg.d_model).double()
    p = {k: torch.tensor(v).double() for k, v in pn.items()
         if k != "shared"}
    probs = torch.softmax(xt @ p["router"], -1)                  # (T, E)
    h = torch.nn.functional.silu(torch.einsum("td,edf->etf", xt, p["wi"]))
    h = h * torch.einsum("td,edf->etf", xt, p["wg"])
    dense = torch.einsum("etf,efd,te->td", h, p["wo"], probs)
    if "shared" in pn:
        sp = {k: torch.tensor(v).double()
              for k, v in pn["shared"].items()}
        dense = dense + (torch.nn.functional.silu(xt @ sp["wi"])
                         * (xt @ sp["wg"])) @ sp["wo"]
    _close(ty.reshape(-1, jcfg.d_model), dense.numpy())
    _close(ty, jy)


def test_lm_loss_and_aux_match_reference():
    jcfg = jget_config("grok-1-314b").reduced(d_model=64)
    params, _ = jm.init_model(jax.random.PRNGKey(3), jcfg)
    model = bridge.model_from_jax(params, bridge.model_config_from(jcfg),
                                  device="cpu")
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jloss, jmet = jax.jit(lambda p, b: jm.lm_loss(p, jcfg, b, remat=False))(
        params, {"tokens": jnp.asarray(toks)})
    loss, met = tm.lm_loss(model, {"tokens": torch.from_numpy(toks)})
    assert float(jmet["aux"]) > 0
    met = {k: float(v.detach()) for k, v in met.items()}
    assert abs(met["aux"] - float(jmet["aux"])) <= AUX_TOL
    assert met["ce"] == pytest.approx(float(jmet["ce"]), rel=REL)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=REL)
    assert float(loss.detach()) == pytest.approx(
        met["ce"] + jcfg.moe.router_aux_weight * met["aux"], rel=1e-6)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads.values())
    assert float(grads["layers.0.mlp.router"].abs().max()) > 0
