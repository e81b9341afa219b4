"""Mixture-of-Experts MLP with top-k routing and capacity-based dispatch
(``repro.models.moe``).

Each token's router softmax (f32, from an f32 router weight even in a
bf16 model) picks its ``top_k`` experts; the (token, choice) pairs are
sorted by expert with a stable argsort, and each expert keeps its first
C = max(K, ceil(T / E * capacity_factor * K)) pairs, in token order, in
an (E, C, d) buffer; the rest are dropped.  T counts the tokens of the
call, so a decode step (T = B) drops otherwise than a prefill.  The
experts are SwiGLU MLPs run as batched products over the buffer;
shared experts (Qwen2-MoE) run densely on every token.

The reference's order-sensitive steps keep its order here:

* top-k takes the lower index among equal probabilities
  (``jax.lax.top_k``): a stable descending sort, not ``torch.topk``;
* the buffer is written with ``index_put_(accumulate=True)`` at each
  pair's slot, zeros for dropped pairs (``.add(mode="drop")``): a slot
  holds at most one non-zero value, so the order of the adds cannot
  change it, and no boolean mask syncs the host;
* the K weighted expert outputs of a token are added over k from left
  to right in the activations' type, the order of the reference's
  scatter-add, with no atomics.

The router's load-balance term is Switch's:
aux = E * sum_e mean_t(probs[:, e]) * count_e / (T * K), in f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import apply_mlp, init_mlp, trunc_normal


class MoE(nn.Module):
    """An MoE MLP's parameters under the JAX package's leaf names:
    ``router`` (d, E) f32, ``wi``/``wg`` (E, d, dff), ``wo`` (E, dff, d),
    and with shared experts ``shared`` (an MLP of width dff times their
    number).  Indexing by name reads a leaf, as for the other blocks'
    parameter dicts.  Calling it applies ``apply_moe``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig,
                 dtype=torch.float32):
        super().__init__()
        m = cfg.moe
        d, E = cfg.d_model, m.num_experts
        dff = m.d_ff_expert or cfg.d_ff
        s_in, s_out = 1 / math.sqrt(d), 1 / math.sqrt(dff)
        # draw order follows the reference's keys: router, wi, wg, wo,
        # then the shared experts
        for name, shape, scale, dt in (
                ("router", (d, E), s_in, torch.float32),
                ("wi", (E, d, dff), s_in, dtype),
                ("wg", (E, d, dff), s_in, dtype),
                ("wo", (E, dff, d), s_out, dtype)):
            self.register_parameter(
                name, nn.Parameter(trunc_normal(shape, scale, gen, dt)))
        if m.num_shared_experts:
            self.shared = init_mlp(gen, d, dff * m.num_shared_experts, dtype,
                                   act=cfg.act)
        self.cfg = cfg

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules

    def forward(self, x):
        return apply_moe(self, x, self.cfg)


def init_moe(gen, cfg: ModelConfig, dtype=torch.float32) -> MoE:
    return MoE(gen, cfg, dtype)


class Routing(NamedTuple):
    """One call's routing of T tokens (N = T * K pairs, pair i is token
    i // K's choice i % K)."""
    probs: torch.Tensor      # (T, E) f32 router softmax
    gate_w: torch.Tensor     # (T, K) f32 weights, renormalised over K
    gate_idx: torch.Tensor   # (T, K) experts, by falling probability
    keep: torch.Tensor       # (N,) bool: the pair fits its expert's C
    slot: torch.Tensor       # (N,) its slot in the buffer (C-1 if dropped)
    capacity: int            # C
    aux: torch.Tensor        # () f32 load-balance term


def capacity(T: int, cfg: ModelConfig, capacity_factor=None) -> int:
    """C, in the reference's Python arithmetic."""
    m = cfg.moe
    cf = capacity_factor if capacity_factor is not None else (
        m.capacity_factor)
    return max(m.top_k, int(math.ceil(T / m.num_experts * cf * m.top_k)))


def route(p, xt, cfg: ModelConfig, capacity_factor=None) -> Routing:
    """Route the tokens xt (T, d): top-k, the capacity drops and aux."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    T = xt.shape[0]
    C = capacity(T, cfg, capacity_factor)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    # a stable descending sort: among equal probabilities the lower
    # expert first, as jax.lax.top_k
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate_w, gate_idx = gate_w[:, :K], gate_idx[:, :K]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = gate_idx.reshape(-1)
    counts = torch.zeros(E, device=xt.device).index_add_(
        0, flat_e, torch.ones(flat_e.shape, device=xt.device))
    aux = E * torch.sum(probs.mean(0) * (counts / (T * K)))

    # each pair's position among its expert's pairs, in pair order
    N = T * K
    ar = torch.arange(N, device=xt.device)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=xt.device))
    pos = torch.empty_like(ar).scatter_(0, order, ar - first[sorted_e])
    keep = pos < C
    return Routing(probs, gate_w, gate_idx, keep,
                   torch.where(keep, pos, C - 1), C, aux)


def apply_moe(p, x, cfg: ModelConfig, capacity_factor=None):
    """x: (..., d).  Returns (y like x, aux () f32)."""
    K = cfg.moe.top_k
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    r = route(p, xt, cfg, capacity_factor)
    flat_e = r.gate_idx.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)

    buf = torch.zeros(cfg.moe.num_experts, r.capacity, d, dtype=x.dtype,
                      device=x.device)
    contrib = torch.where(r.keep[:, None], xt[flat_t], 0).to(x.dtype)
    buf.index_put_((flat_e, r.slot), contrib, accumulate=True)
    h = F.silu(torch.bmm(buf, p["wi"])) * torch.bmm(buf, p["wg"])
    out_buf = torch.bmm(h, p["wo"])                           # (E, C, d)

    w = torch.where(r.keep, r.gate_w.reshape(-1), 0.0).to(x.dtype)
    weighted = (out_buf[flat_e, r.slot] * w[:, None]).reshape(T, K, d)
    y = weighted[:, 0]
    for k in range(1, K):
        y = y + weighted[:, k]
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xt, act=cfg.act)
    return y.reshape(*lead, d), r.aux
