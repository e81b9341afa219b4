"""Plain reference of the Tryage engine's answers (``tryage-bert11``).

For one request (a masked 512-token prompt, its MLM targets and mask,
and its constraint weights) the engine answers with the router's
predicted loss of every expert, the expert it picked, and that expert's
per-position predictions and masked NLL.  This file computes the same
from the configuration and the benchmark's weights alone:

- the router: a bidirectional encoder (``transformer.hidden``), its
  hidden states mean-pooled over the non-pad (non-zero) tokens, then
  ``softplus(gelu_tanh(e w1 + b1) w2 + b2)``: the predicted losses;
- the decision: ``argmin`` of ``pred + sum_j lambda_j C_j`` in float64,
  with ``C_size = n_params / max n_params`` and ``C_recency = 1 -
  recency`` (the paper's linear size penalty and staleness);
- the expert: the same encoder at its own widths, vocabulary and
  layernorm epsilon, with tied logits over every position; predictions
  are the argmax, the NLL the mean of ``logsumexp - gold`` over the
  masked positions.

Router and experts give their sizes under their checkpoints' keys
(``num_hidden_layers``, ``hidden_size``, ``num_attention_heads``,
``intermediate_size``, ``vocab_size``, ``layer_norm_eps``).  Weights
are keyed ``router.`` + the encoder's names (``transformer``) and
``router.head.w1`` (d, hh), ``b1``, ``w2`` (hh, M), ``b2``; each
expert's under ``experts.<name>.``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference import transformer as T
from reference.precision import Products


def shape(cfg: dict, m: dict) -> T.Shape:
    """The encoder of the router or of an expert ``m``."""
    enc = cfg["prompt_encoder"]
    return T.Shape(layers=m["num_hidden_layers"], d=m["hidden_size"],
                   heads=m["num_attention_heads"],
                   kv_heads=m["num_attention_heads"],
                   ff=m["intermediate_size"], vocab=m["vocab_size"],
                   rope_theta=enc["rope_theta"], causal=enc["causal"],
                   eps=m["layer_norm_eps"])


def router_shape(cfg: dict) -> T.Shape:
    return shape(cfg, cfg["router"])


def expert_shape(cfg: dict, e: dict) -> T.Shape:
    return shape(cfg, e)


def param_specs(cfg: dict) -> list:
    """Every weight: (name, shape, role), the router's first."""
    r = cfg["router"]
    d, hh, M = r["hidden_size"], r["head_hidden"], r["n_models"]
    out = T.param_specs(router_shape(cfg), "router.encoder.")
    out += [("router.head.w1", (d, hh), ("matrix", d)),
            ("router.head.b1", (hh,), ("bias",)),
            ("router.head.w2", (hh, M), ("matrix", hh)),
            ("router.head.b2", (M,), ("bias",))]
    for e in cfg["experts"]:
        out += T.param_specs(expert_shape(cfg, e), f"experts.{e['name']}.")
    return out


def n_params(cfg: dict, e: dict) -> int:
    return sum(int(np.prod(shape)) for _, shape, _ in
               T.param_specs(expert_shape(cfg, e)))


def constraint_matrix(cfg: dict) -> np.ndarray:
    """(n_c, M) float64, in the order of ``cfg["constraints"]``."""
    sizes = np.array([n_params(cfg, e) for e in cfg["experts"]], np.float64)
    rec = np.array([e["recency"] for e in cfg["experts"]], np.float64)
    rows = {"size": sizes / sizes.max(), "recency": 1.0 - rec}
    return np.stack([rows[name] for name in cfg["constraints"]])


def softplus(x):
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


@torch.no_grad()
def pooled(w, cfg: dict, tokens: torch.Tensor, P: Products):
    """The router encoder's mean-pooled states (B, d) float32 for prompts
    (B, S)."""
    h = T.hidden(w, router_shape(cfg), tokens, P, "router.encoder.")
    valid = (tokens != 0).float()[..., None]
    return (h * valid).sum(1) / valid.sum(1).clamp_min(1.0)


def head_hidden(w, emb: torch.Tensor, P: Products):
    """The head's hidden layer (B, hh) float32 of pooled states (B, d)."""
    return F.gelu(P.mm(emb, w["router.head.w1"].float())
                  + w["router.head.b1"].float(), approximate="tanh")


@torch.no_grad()
def predict(w, cfg: dict, tokens: torch.Tensor, P: Products):
    """Predicted losses (B, M) float32 for prompts (B, S)."""
    g = head_hidden(w, pooled(w, cfg, tokens, P), P)
    return softplus(P.mm(g, w["router.head.w2"].float())
                    + w["router.head.b2"].float())


def scores(cfg: dict, pred: np.ndarray, lambdas: np.ndarray) -> np.ndarray:
    """Constrained routing scores (B, M) float64: pred + lambdas @ C."""
    return pred.astype(np.float64) + lambdas @ constraint_matrix(cfg)


@torch.no_grad()
def expert_eval(w, cfg: dict, name: str, tokens, targets, mask,
                P: Products):
    """(logits (B, S, V) float32, masked NLL (B,) float64) of expert
    ``name`` over prompts (B, S)."""
    e = next(x for x in cfg["experts"] if x["name"] == name)
    prefix = f"experts.{name}."
    h = T.hidden(w, expert_shape(cfg, e), tokens, P, prefix)
    logits = T.logits(w, h, P, prefix)
    lse = torch.logsumexp(logits.double(), -1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0].double()
    m = mask.double()
    nll = ((lse - gold) * m).sum(-1) / m.sum(-1).clamp_min(1.0)
    return logits, nll
