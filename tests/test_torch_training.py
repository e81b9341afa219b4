"""The port's training path (``repro_torch.core.training``,
``models.model.lm_loss``, ``optim``) against the JAX package's.

Both packages start from the same weights (JAX-initialised, carried
across by ``repro_torch.bridge``) and see the same numpy batches; the
port's attention runs its plain version under torch autograd on the
CPU, the JAX package's XLA autodiff.

Tolerances (f32 sums in other orders): losses to rtol 1e-5 for one
evaluation and 1e-4 after training steps; gradients and trained weights
within 1e-5 (one step) or 1e-4 (a few steps) of each leaf's largest
magnitude.  After ``train_router``'s 32 Adam steps the best weights are
held to 1e-3: Adam divides each gradient by its own running magnitude,
so embedding rows whose gradients are near zero carry the f32 noise of
those gradients into full-size steps.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import router as trouter
from repro_torch.core import training as ttr
from repro_torch.data.batching import BatchIterator as TBatches
from repro_torch.data.corpus import DomainCorpus as TCorpus
from repro_torch.models import model as tm
from repro_torch.optim import adamw_init as tadamw_init
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import training as jtr  # noqa: E402
from repro.core.library import _enc  # noqa: E402
from repro.core.router import RouterConfig, init_router  # noqa: E402
from repro.data.batching import BatchIterator as JBatches  # noqa: E402
from repro.data.batching import mlm_batch  # noqa: E402
from repro.data.corpus import DomainCorpus as JCorpus  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.common import ModelConfig  # noqa: E402
from repro.optim import adamw_init, adamw_update  # noqa: E402

RC = RouterConfig(n_models=3, vocab_size=64, num_layers=1, d_model=32,
                  num_heads=2, d_ff=64)
PORT_RC = trouter.RouterConfig(**vars(RC))


def _close_leaves(got: dict, want: dict, rel):
    assert sorted(got) == sorted(want)
    for n in want:
        w = np.asarray(want[n], np.float64)
        g = np.asarray(got[n], np.float64)
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= rel * scale, (n, np.abs(g - w).max(),
                                                   scale)


def _state(module):
    return {n: p.detach().numpy() for n, p in module.named_parameters()}


def _grads(module):
    return {n: p.grad.numpy() for n, p in module.named_parameters()}


def _to_t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
            if k != "domain"}


def _decoder_cfg():
    return ModelConfig(name="dec", family="dense", num_layers=2, d_model=32,
                       num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64,
                       dtype="float32")


# ------------------------------------------------------------ lm_loss

@pytest.mark.parametrize("kind", ["mlm", "clm"])
def test_lm_loss_value_and_grad_match_jax(kind):
    jcfg = _enc("t", 2, 32, 2, 64, 64) if kind == "mlm" else _decoder_cfg()
    params, _ = jm.init_model(jax.random.PRNGKey(0), jcfg)
    model = bridge.model_from_jax(params, bridge.model_config_from(jcfg),
                                  device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 64, size=(4, 24)).astype(np.int32)
    batch = mlm_batch(toks, rng, 0.3, 64)
    if kind == "clm":
        batch = {"tokens": toks, "mask": (rng.random(toks.shape) < 0.8)
                 .astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.lm_loss(p, jcfg, jb, remat=False), has_aux=True)(params)
    loss, metrics = tm.lm_loss(model, _to_t(batch))
    loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(metrics["ce"].detach()) == float(loss)
    _close_leaves(_grads(model), bridge.model_state(jg), 1e-5)
    # the tied embedding is one parameter: its gradient sums both uses
    assert [n for n, _ in model.named_parameters()].count("embed.table") == 1


def test_cross_entropy_empty_mask_divides_by_one():
    logits = torch.randn(2, 3, 5)
    got = tm.cross_entropy(logits, torch.zeros(2, 3, dtype=torch.long),
                           torch.zeros(2, 3))
    assert float(got) == 0.0


def test_expert_steps_match_jax():
    """3 steps of train_expert's step on the same BatchIterator batches:
    loss per step within 1e-4, weights within 1e-4 of each leaf's
    largest magnitude."""
    jcfg = _enc("t", 2, 32, 2, 64, 64)
    params, _ = jm.init_model(jax.random.PRNGKey(1), jcfg)
    model = bridge.model_from_jax(params, bridge.model_config_from(jcfg),
                                  device="cpu")
    mix = {"github": 0.5, "pubmed": 0.5}
    jit_ = JBatches(JCorpus(vocab_size=64, seed=0), mix, 8, 32, seed=2)
    tit = TBatches(TCorpus(vocab_size=64, seed=0), mix, 8, 32, seed=2)
    jopt, topt = adamw_init(params), tadamw_init(model)

    @jax.jit
    def jstep(p, o, b):
        (loss, _), g = jax.value_and_grad(
            lambda pp: jm.lm_loss(pp, jcfg, b, remat=False),
            has_aux=True)(p)
        p2, o2 = adamw_update(p, g, o, lr=1e-3, weight_decay=1e-5)
        return p2, o2, loss

    for _ in range(3):
        jb, tb = next(jit_), next(tit)
        assert (jb["tokens"] == tb["tokens"]).all()
        jbatch = {k: jnp.asarray(v) for k, v in jb.items() if k != "domain"}
        params, jopt, jl = jstep(params, jopt, jbatch)
        topt, tl = ttr.expert_step(model, topt, _to_t(tb), lr=1e-3)
        assert abs(float(tl) - float(jl)) <= 1e-4
    assert topt.step == 3
    _close_leaves(_state(model), bridge.model_state(params), 1e-4)


# ------------------------------------------------------------- router

def _router(seed=9, uncertainty=True):
    rp, _ = init_router(jax.random.PRNGKey(seed), RC,
                        uncertainty=uncertainty)
    return rp, bridge.router_from_jax(rp, PORT_RC, device="cpu")


def _toks(n, seed=0, S=16):
    return np.random.default_rng(seed).integers(
        4, 64, size=(n, S)).astype(np.int32)


@pytest.mark.parametrize("divergence,unc", [("mse", False), ("huber", False),
                                            ("mse", True), ("huber", True)])
def test_router_loss_value_and_grad_match_jax(divergence, unc):
    rp, router = _router(uncertainty=unc)
    toks = _toks(8)
    targets = np.random.default_rng(1).uniform(0, 4, (8, 3)).astype(
        np.float32)
    jl, jg = jax.value_and_grad(lambda p: jtr.router_loss(
        p, RC, {"tokens": jnp.asarray(toks)}, targets, divergence))(rp)
    loss = ttr.router_loss(router, PORT_RC,
                           {"tokens": torch.from_numpy(toks)}, targets,
                           divergence)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _close_leaves(_grads(router), bridge.router_state(jg), 1e-5)


def _qtable(n, seed, level):
    rng = np.random.default_rng(seed)
    return {"tokens": _toks(n, seed),
            "loss": (level + 0.1 * rng.standard_normal((n, 3))).astype(
                np.float32)}


def test_train_router_matches_jax_and_returns_the_best_step():
    """Train targets sit near 3 and validation targets near 1.5, above
    the initial predictions: validation improves while predictions rise
    through 1.5, then worsens, so the last step is not the best."""
    rp, router = _router(seed=3, uncertainty=False)
    train, val = _qtable(64, 0, 3.0), _qtable(16, 1, 1.5)
    kw = dict(epochs=4, batch=8, lr=3e-2, lr_decay=0.9, patience=100,
              seed=5, verbose=False)
    jbest, jlog = jtr.train_router(rp, RC, train, val, **kw)
    tbest, tlog = ttr.train_router(router, PORT_RC, train, val, **kw)
    assert tlog.steps == jlog.steps
    assert tlog.best_step == jlog.best_step
    assert tlog.stopped_early == jlog.stopped_early
    np.testing.assert_allclose(tlog.val_loss, jlog.val_loss, atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tlog.train_loss, jlog.train_loss, atol=1e-4,
                               rtol=1e-4)
    assert tlog.best_step < tlog.steps[-1]
    assert tlog.val_loss[-1] > tlog.best_val + 1e-3
    _close_leaves(_state(tbest), bridge.router_state(jbest), 1e-3)
    # the returned weights are the best step's, not the last ones
    with torch.no_grad():
        vl = float(ttr.router_loss(tbest, PORT_RC, {"tokens": torch.from_numpy(
            val["tokens"])}, val["loss"]))
    assert vl == pytest.approx(tlog.best_val, rel=1e-6)
    assert tbest is not router
    assert not torch.equal(tbest.head["b2"], router.head["b2"])


def test_calibrate_uncertainty_matches_jax():
    rp, router = _router(seed=4, uncertainty=True)
    toks = _toks(48, 2)
    targets = np.random.default_rng(3).uniform(0.5, 3, (48, 3)).astype(
        np.float32)
    kw = dict(steps=12, batch=16, lr=3e-3, seed=0)
    jout = jtr.calibrate_uncertainty(rp, RC, toks, targets, **kw)
    before = copy.deepcopy(_state(router))
    tout = ttr.calibrate_uncertainty(router, PORT_RC, toks, targets, **kw)
    _close_leaves(_state(tout), bridge.router_state(jout), 1e-4)
    # encoder and loss head shared and untouched; the input left as it was
    assert tout.encoder is router.encoder and tout.head is router.head
    assert tout.unc is not router.unc
    for n, a in _state(router).items():
        assert np.array_equal(a, before[n]), n


@pytest.mark.parametrize("trainable", ["head", "all"])
@pytest.mark.parametrize("ema", [0.0, 0.5])
def test_router_update_step_matches_jax(trainable, ema):
    rp, router = _router(seed=6, uncertainty=True)
    rng = np.random.default_rng(7)
    toks = _toks(12, 4)
    eidx = rng.integers(0, 3, 12).astype(np.int32)
    obs = rng.uniform(0.5, 3, 12).astype(np.float32)
    jstep = jtr.make_router_update_step(RC, lr=0.1, ema=ema,
                                        trainable=trainable)
    jnew, jl = jstep(rp, jnp.asarray(toks), jnp.asarray(eidx),
                     jnp.asarray(obs))
    before = copy.deepcopy(_state(router))
    tstep = ttr.make_router_update_step(PORT_RC, lr=0.1, ema=ema,
                                        trainable=trainable)
    tnew, tl = tstep(router, torch.from_numpy(toks), eidx, obs)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close_leaves(_state(tnew), bridge.router_state(jnew), 1e-5)
    jerr = jtr.router_prediction_error(jnew, RC, jnp.asarray(toks), eidx,
                                       obs)
    with torch.no_grad():
        terr = ttr.router_prediction_error(tnew, PORT_RC,
                                           torch.from_numpy(toks), eidx,
                                           obs)
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-5)
    # shadow weights: the live router is untouched, "unc" is shared
    for n, a in _state(router).items():
        assert np.array_equal(a, before[n]), n
    assert tnew.unc is router.unc and tnew.head is not router.head
    assert (tnew.encoder is router.encoder) == (trainable == "head")
    with pytest.raises(ValueError):
        ttr.make_router_update_step(PORT_RC, ema=1.0)
