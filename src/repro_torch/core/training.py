"""Router training (paper eq. 2/3), expert pre-training, and the online
adaptation step that keeps a deployed router tracking expert drift: the
port of ``repro.core.training``.

Paper recipe, reproduced: ADAM, weight decay 1e-5, lr 5e-5 with
exponential decay 0.9, inputs curtailed to a fixed token budget, early
stopping with patience conditioned on validation loss measured 4x per
epoch, checkpointing of the best validation model.

Where the JAX package returns new parameter trees, the port trains a
module in place (``optim.adamw_update``); the best validation router is
therefore a real copy (``copy.deepcopy``), not a second name for the
weights training goes on to change.  The online step is the exception:
it never mutates the live router and returns a new one
(``core.router.with_modules``), which the engine publishes with
``VersionedParams.swap``.  On the card, gradients through attention run
the backward kernel (``kernels.flash_attention``); the router heads'
loss stays torch ops, as the JAX package computes it in XLA.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch
from torch import nn

from repro_torch.core.library import ExpertSpec, ModelLibrary
from repro_torch.core.router import (Router, RouterConfig,
                                     add_uncertainty_head, losses_from_emb,
                                     predict_losses, router_embed,
                                     uncertainty_from_emb, with_modules)
from repro_torch.data.batching import BatchIterator
from repro_torch.data.corpus import DomainCorpus
from repro_torch.device import module_device, resolve_device
from repro_torch.kernels import sanitize
from repro_torch.models.model import Model, count_params, init_model, lm_loss
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               exp_decay_schedule)
from repro_torch.optim.adamw import grads_of


@dataclasses.dataclass
class TrainLog:
    steps: list = dataclasses.field(default_factory=list)
    train_loss: list = dataclasses.field(default_factory=list)
    val_loss: list = dataclasses.field(default_factory=list)
    best_val: float = float("inf")
    best_step: int = -1
    stopped_early: bool = False


def to_device(batch: dict, device) -> dict:
    """A numpy batch's arrays (``domain`` left out) as tensors on
    ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if k != "domain"}


# ----------------------------------------------------------- experts

@sanitize.owns
def expert_step(model: Model, opt: OptState, batch: dict, *, lr,
                weight_decay=1e-5) -> tuple[OptState, torch.Tensor]:
    """One training step of an expert: forward, ``lm_loss``, backward
    and ``adamw_update`` (in place).  ``batch`` holds tensors on the
    model's device.  Returns (new optimizer state, the step's loss)."""
    model.zero_grad(set_to_none=True)
    loss, _ = lm_loss(model, batch, remat=False)
    loss.backward()
    _, opt = adamw_update(model, grads_of(model), opt, lr=lr,
                          weight_decay=weight_decay)
    return opt, loss.detach()


def train_expert(spec: ExpertSpec, corpus: DomainCorpus, *, steps=300,
                 batch=16, seq=128, lr=1e-3, seed=0, log_every=100,
                 verbose=False, device=None,
                 log: TrainLog | None = None) -> ExpertSpec:
    """MLM-train one expert on its domain mixture (weights drawn from
    ``torch.Generator(seed)`` on ``device``).  With ``log`` each step's
    loss is appended to it (read back in one sync at the end)."""
    dev = resolve_device(device)
    model = init_model(spec.cfg, seed=seed, device=dev)
    opt = adamw_init(model)
    it = BatchIterator(corpus, spec.train_mixture, batch, seq, seed=seed + 1)
    losses = []
    for i in range(steps):
        opt, loss = expert_step(model, opt, to_device(next(it), dev), lr=lr)
        losses.append(loss)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"    {spec.name} step {i} loss {float(loss):.3f}",
                  flush=True)
    if log is not None and losses:
        log.steps.extend(range(1, steps + 1))
        log.train_loss.extend(torch.stack(losses).cpu().tolist())
    spec.params = model
    spec.n_params = count_params(model)
    return spec


def train_library(library: ModelLibrary, corpus: DomainCorpus, *,
                  steps=300, batch=16, seq=128, seed=0, verbose=True,
                  device=None, logs: list | None = None) -> ModelLibrary:
    """Train every expert (seeds ``seed + i``); with ``logs`` one
    ``TrainLog`` of step losses per expert is appended to it."""
    for i, e in enumerate(library.experts):
        t0 = time.time()
        log = TrainLog() if logs is not None else None
        train_expert(e, corpus, steps=steps, batch=batch, seq=seq,
                     seed=seed + i, verbose=False, device=device, log=log)
        if logs is not None:
            logs.append(log)
        if verbose:
            print(f"  trained {e.name}: {e.n_params:,d} params "
                  f"({time.time()-t0:.0f}s)", flush=True)
    return library


# ------------------------------------------------------------ router

def router_loss(params: Router, rc: RouterConfig, batch, target_losses,
                divergence="mse", unc_weight: float = 0.5):
    """Divergence D(R(z;W) || L(z, M_i)) summed over the library (eq. 2).

    When ``params`` carries an uncertainty head (``unc``), a residual-
    regression term trains it alongside loss prediction: sigma chases
    ``|L-hat - L|`` with both the residual and the embedding detached
    (the reference's two ``stop_gradient``s), so the head learns to
    predict how wrong the loss head is without perturbing the loss
    head's or the encoder's gradients."""
    emb = router_embed(params, rc, batch)
    pred = losses_from_emb(params.head, emb)
    t = torch.as_tensor(target_losses, dtype=torch.float32,
                        device=pred.device)
    if divergence == "mse":
        loss = (pred - t).square().mean()
    elif divergence == "huber":
        d = (pred - t).abs()
        loss = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()
    else:
        raise ValueError(divergence)
    if params.unc is not None and unc_weight:
        resid = (pred - t).abs().detach()
        sigma = uncertainty_from_emb(params.unc, emb.detach())
        loss = loss + unc_weight * (sigma - resid).square().mean()
    return loss


@sanitize.owns
def router_step(router: Router, opt: OptState, rc: RouterConfig, toks,
                targets, *, lr, weight_decay=1e-5,
                divergence="mse") -> tuple[OptState, torch.Tensor]:
    """One supervised router step (``router_loss``, backward,
    ``adamw_update`` in place).  Returns (new state, the loss)."""
    router.zero_grad(set_to_none=True)
    loss = router_loss(router, rc, {"tokens": toks}, targets, divergence)
    loss.backward()
    _, opt = adamw_update(router, grads_of(router), opt, lr=lr,
                          weight_decay=weight_decay)
    return opt, loss.detach()


@torch.no_grad()
@sanitize.owns
def map_chunks(fn, tokens: np.ndarray, device, B=256) -> np.ndarray:
    """``fn`` over ``tokens`` (N, S) in chunks of ``B`` rows on
    ``device``, without grad; the outputs concatenated as numpy."""
    return np.concatenate([
        fn(torch.from_numpy(np.ascontiguousarray(tokens[i:i + B]))
           .to(device)).cpu().numpy()
        for i in range(0, len(tokens), B)])


def calibrate_uncertainty(router_params: Router, rc: RouterConfig, tokens,
                          target_losses, *, steps=300, batch=64, lr=3e-3,
                          seed=0, verbose=False) -> Router:
    """Retrofit + train an uncertainty head on a frozen router.

    Attaches a fresh ``unc`` head when there is none
    (``router.add_uncertainty_head``) and regresses it onto the frozen
    router's absolute residuals ``|L-hat(z) - L(z, M_i)|`` over a
    held-out (tokens, loss) table; embeddings and residuals are
    precomputed once.  Returns a new router sharing the encoder and
    loss head (routing decisions are bit-identical) with its own trained
    ``unc``; ``router_params`` is left as it was."""
    if router_params.unc is None:
        router_params = add_uncertainty_head(router_params, rc, seed + 17)
    dev = module_device(router_params)
    emb = map_chunks(lambda t: router_embed(router_params, rc,
                                            {"tokens": t}), tokens, dev)
    pred = map_chunks(lambda t: predict_losses(router_params, rc,
                                               {"tokens": t}), tokens, dev)
    resid = np.abs(pred - np.asarray(target_losses, np.float32))

    unc = copy.deepcopy(router_params.unc)
    opt = adamw_init(unc)
    emb_d, resid_d = (torch.from_numpy(a).to(dev) for a in (emb, resid))
    rng = np.random.default_rng(seed)
    for s in range(steps):
        idx = torch.from_numpy(
            rng.integers(0, len(emb), size=min(batch, len(emb)))).to(dev)
        unc.zero_grad(set_to_none=True)
        l = (uncertainty_from_emb(unc, emb_d[idx]) - resid_d[idx]).square() \
            .mean()
        l.backward()
        _, opt = adamw_update(unc, grads_of(unc), opt, lr=lr,
                              weight_decay=1e-5)
        if verbose and s % 100 == 0:
            print(f"  calibrate_uncertainty step {s} loss {float(l):.4f}",
                  flush=True)
    return with_modules(router_params, unc=unc)


# ------------------------------------------------- online adaptation

def _selected(params: Router, rc: RouterConfig, toks, expert_idx):
    pred = predict_losses(params, rc, {"tokens": toks})
    idx = torch.as_tensor(expert_idx, dtype=torch.long,
                          device=pred.device)[:, None]
    return pred.gather(1, idx)[:, 0]


@sanitize.owns
def router_prediction_error(params: Router, rc: RouterConfig, toks,
                            expert_idx, observed):
    """Mean |L-hat[chosen] - L_observed| over a feedback batch — the
    adaptation loop's before/after health metric."""
    sel = _selected(params, rc, toks, expert_idx)
    obs = torch.as_tensor(observed, dtype=torch.float32, device=sel.device)
    return (sel - obs).abs().mean()


def make_router_update_step(rc: RouterConfig, *, lr: float = 1e-2,
                            ema: float = 0.0, trainable: str = "all"):
    """Build the incremental update for online router adaptation.

    The returned ``step(params, toks, expert_idx, observed)`` performs
    one SGD step on the *bandit* regression loss

        mean_i (L-hat(z_i)[a_i] - L_obs(z_i, a_i))^2

    where ``a_i`` is the expert that actually served prompt ``z_i`` and
    ``L_obs`` its measured masked NLL (``serving.feedback``).  It
    returns ``(new_params, loss)``; ``params`` is never mutated (shadow
    weights): the new router shares every module the step does not
    train, and the caller publishes it atomically via
    ``core.router.VersionedParams.swap``.

    ``ema`` in [0, 1) blends the step back toward the current weights
    (``new = ema * old + (1 - ema) * sgd``); 0 is plain SGD.
    ``trainable``: ``"all"`` adapts encoder + loss head (through the
    attention backward), ``"head"`` runs the encoder without grad and
    adapts the loss head only.  The uncertainty head is never touched.
    Runs with grad enabled, so the caller must not be inside
    ``torch.inference_mode``."""
    if not 0.0 <= ema < 1.0 or trainable not in ("all", "head"):
        raise ValueError(f"ema {ema} must be in [0, 1) and trainable "
                         f"{trainable!r} 'all' or 'head'")

    def _sgd(module: nn.Module, grads) -> nn.Module:
        new = copy.deepcopy(module)
        with torch.no_grad():
            for p, w, g in zip(new.parameters(), module.parameters(),
                               grads):
                p.copy_(w - lr * g)
                if ema:
                    p.copy_(ema * w + (1.0 - ema) * p)
        return new

    @sanitize.owns
    def step(params: Router, toks, expert_idx, observed):
        obs = torch.as_tensor(observed, dtype=torch.float32,
                              device=toks.device)
        idx = torch.as_tensor(expert_idx, dtype=torch.long,
                              device=toks.device)[:, None]
        with torch.enable_grad():
            if trainable == "head":
                with torch.no_grad():
                    emb = router_embed(params, rc, {"tokens": toks})
                pred = losses_from_emb(params.head, emb)
                live = {"head": params.head}
            else:
                pred = predict_losses(params, rc, {"tokens": toks})
                live = {"encoder": params.encoder, "head": params.head}
            loss = (pred.gather(1, idx)[:, 0] - obs).square().mean()
            leaves = [p for m in live.values() for p in m.parameters()]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        new, i = {}, 0
        for name, module in live.items():
            n = len(list(module.parameters()))
            new[name] = _sgd(module, grads[i:i + n])
            i += n
        return with_modules(params, **new), loss.detach()

    return step


def train_router(router_params: Router, rc: RouterConfig, train_data,
                 val_data, *, epochs=8, batch=32, lr=5e-5, lr_decay=0.9,
                 patience=16, weight_decay=1e-5, seed=0, divergence="mse",
                 verbose=True) -> tuple[Router, TrainLog]:
    """Supervised router training with the paper's recipe.

    train_data/val_data: dicts {"tokens": (N,S), "loss": (N, n_models)}.
    lr decays exponentially by ``lr_decay`` per epoch; validation is
    measured 4x per epoch; early stopping patience in validation checks.
    ``router_params`` is trained in place; the returned router is a copy
    of it at the best validation step."""
    N = train_data["tokens"].shape[0]
    steps_per_epoch = max(N // batch, 1)
    schedule = exp_decay_schedule(lr, lr_decay, steps_per_epoch)
    opt = adamw_init(router_params)
    rng = np.random.default_rng(seed)
    log = TrainLog()
    best_params = copy.deepcopy(router_params)
    val_every = max(steps_per_epoch // 4, 1)
    bad = 0
    dev = module_device(router_params)
    dev_arr = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        dev, dt)
    train_tok = dev_arr(train_data["tokens"], torch.long)
    train_loss = dev_arr(train_data["loss"], torch.float32)
    val_tok = dev_arr(val_data["tokens"], torch.long)
    val_loss = dev_arr(val_data["loss"], torch.float32)

    step = 0
    l = None
    for ep in range(epochs):
        perm = rng.permutation(N)
        for s in range(steps_per_epoch):
            idx = torch.from_numpy(perm[s * batch:(s + 1) * batch]).to(dev)
            opt, l = router_step(router_params, opt, rc, train_tok[idx],
                                 train_loss[idx], lr=schedule,
                                 weight_decay=weight_decay,
                                 divergence=divergence)
            step += 1
            if step % val_every == 0:
                with torch.no_grad():
                    vl = float(router_loss(router_params, rc,
                                           {"tokens": val_tok}, val_loss,
                                           divergence))
                log.steps.append(step)
                log.train_loss.append(float(l))
                log.val_loss.append(vl)
                if vl < log.best_val - 1e-5:
                    log.best_val, log.best_step = vl, step
                    best_params = copy.deepcopy(router_params)
                    bad = 0
                else:
                    bad += 1
                if bad >= patience:
                    log.stopped_early = True
                    if verbose:
                        print(f"  early stop at step {step} "
                              f"(best val {log.best_val:.4f})", flush=True)
                    return best_params, log
        if verbose:
            print(f"  epoch {ep}: train {float(l):.4f} "
                  f"val {log.val_loss[-1] if log.val_loss else float('nan'):.4f}",
                  flush=True)
    return best_params, log
