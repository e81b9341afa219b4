"""The perceptive router R(z, M_i; W).

A small bidirectional encoder with a regression head that predicts an
|M|-dimensional vector of downstream losses (the learned Q function over
routing actions), and optionally an uncertainty head — a second MLP over
the same pooled embedding predicting the loss head's per-expert absolute
residual.  Without the uncertainty head every consumer falls back to the
constant prior sigma = 1.

``Router`` holds the JAX package's router tree as modules: ``encoder``
(a ``models.model.Model``), ``head`` and optionally ``unc`` (each an
``nn.ParameterDict`` of w1 (d, hh), b1, w2 (hh, M), b2).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.router_score.ops import head_plain
from repro_torch.models.common import AttnConfig, ModelConfig
from repro_torch.models.layers import trunc_normal
from repro_torch.models.model import Model, encode


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    n_models: int
    vocab_size: int = 512
    num_layers: int = 4           # BERT-small scale
    d_model: int = 128
    num_heads: int = 4
    d_ff: int = 512
    head_hidden: int = 128

    def encoder_config(self) -> ModelConfig:
        return ModelConfig(
            name="tryage-router", num_layers=self.num_layers, d_model=self.d_model,
            num_heads=self.num_heads, num_kv_heads=self.num_heads,
            d_ff=self.d_ff, vocab_size=self.vocab_size,
            attn=AttnConfig(rope_theta=10000.0, causal=False),
            is_encoder=True, tie_embeddings=True, norm_kind="layernorm",
            act="gelu", dtype="float32")


@dataclasses.dataclass(frozen=True)
class VersionedParams:
    """Immutable router snapshot with a monotone version.  The version
    is part of every decision-cache key: ``swap`` publishes new
    parameters as version + 1, which makes every older verdict
    unreachable."""

    params: nn.Module
    version: int = 0

    def swap(self, new_params: nn.Module) -> "VersionedParams":
        """Publish ``new_params`` as the next snapshot (version + 1)."""
        return VersionedParams(new_params, self.version + 1)


# softplus floor on predicted residuals: keeps sigma > 0 so confidence
# 1/(1+sigma) stays strictly below 1 and escalation thresholds behave.
UNC_FLOOR = 1e-3


def _init_mlp_head(gen, rc: RouterConfig) -> nn.ParameterDict:
    d, hh = rc.d_model, rc.head_hidden
    return nn.ParameterDict({
        "w1": nn.Parameter(trunc_normal((d, hh), 1 / math.sqrt(d), gen)),
        "b1": nn.Parameter(torch.zeros(hh)),
        "w2": nn.Parameter(trunc_normal((hh, rc.n_models), 1 / math.sqrt(hh),
                                        gen)),
        "b2": nn.Parameter(torch.zeros(rc.n_models)),
    })


class Router(nn.Module):
    def __init__(self, rc: RouterConfig, gen: torch.Generator,
                 uncertainty: bool = False):
        super().__init__()
        self.rc = rc
        self.encoder = Model(rc.encoder_config(), gen)
        self.head = _init_mlp_head(gen, rc)
        self.unc = _init_mlp_head(gen, rc) if uncertainty else None


def init_router(rc: RouterConfig, seed: int = 0, uncertainty: bool = False,
                device=None) -> Router:
    """A router with weights drawn from ``torch.Generator(seed)`` on the
    CPU, then moved to ``device`` (default: the card; raises without
    one)."""
    dev = resolve_device(device)
    return Router(rc, torch.Generator().manual_seed(seed), uncertainty).to(dev)


def with_modules(router: Router, **modules) -> Router:
    """A new ``Router`` that shares every submodule of ``router`` except
    the ones given (``encoder``, ``head``, ``unc``): the counterpart of
    ``{**params, "head": new_head}`` on the JAX package's dict trees.
    ``router`` itself is left as it was."""
    out = copy.copy(router)
    out._modules = dict(router._modules)
    for name, module in modules.items():
        out.__dict__.pop(name, None)   # an absent head is a plain None
        out._modules[name] = module
    return out


def add_uncertainty_head(router: Router, rc: RouterConfig,
                         seed: int = 0) -> Router:
    """Retrofit an uncertainty head onto a pre-cascade checkpoint: a
    router sharing the encoder and loss head (so its loss predictions
    are bit-identical) with a fresh ``unc`` head drawn from
    ``torch.Generator(seed)`` on the CPU."""
    dev = router.head["w1"].device
    unc = _init_mlp_head(torch.Generator().manual_seed(seed), rc).to(dev)
    return with_modules(router, unc=unc)


def _pool(hidden, tokens):
    """Mean-pool over non-pad positions. hidden (B,S,d), tokens (B,S)."""
    valid = (tokens != 0).to(hidden.dtype)[..., None]
    return (hidden * valid).sum(1) / valid.sum(1).clamp_min(1.0)


def router_embed(params: Router, rc: RouterConfig, batch):
    """Pooled prompt embedding (B, d)."""
    return _pool(encode(params.encoder, batch), batch["tokens"])


def _head(p, emb):
    return head_plain(emb, p["w1"], p["b1"], p["w2"], p["b2"])


def losses_from_emb(head_params, emb):
    """L-hat (B, n_models) = softplus(gelu(emb @ w1 + b1) @ w2 + b2)."""
    return _head(head_params, emb)


def uncertainty_from_emb(unc_params, emb):
    """sigma (B, n_models): predicted |L-hat - L|, strictly positive."""
    return _head(unc_params, emb) + UNC_FLOOR


def predict_losses(params: Router, rc: RouterConfig, batch):
    """Predicted per-expert losses L-hat (B, n_models)."""
    return losses_from_emb(params.head, router_embed(params, rc, batch))


def predict_uncertainty(params: Router, rc: RouterConfig, batch):
    """Per-expert sigma (B, n_models); the constant prior 1 without an
    uncertainty head."""
    emb = router_embed(params, rc, batch)
    if params.unc is None:
        return torch.ones(emb.shape[0], rc.n_models, device=emb.device)
    return uncertainty_from_emb(params.unc, emb)
