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
from repro_torch.models.layers import (apply_mlp, init_mlp, mlp_logical,
                                       trunc_normal)
from repro_torch.sharding import local
from repro_torch.sharding.context import is_dtensor, shard_act


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


def moe_logical(cfg: ModelConfig) -> dict:
    """Logical axes of an ``MoE``'s leaves."""
    out = {"router": ("embed", "expert"),
           "wi": ("expert", "embed", "mlp"),
           "wg": ("expert", "embed", "mlp"),
           "wo": ("expert", "mlp", "embed")}
    if cfg.moe.num_shared_experts:
        out["shared"] = mlp_logical(cfg.act)
    return out


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
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    if is_dtensor(xt):
        y, aux = _sharded_experts(p, xt, cfg, capacity_factor)
    else:
        y, aux = _experts(xt, p["router"], p["wi"], p["wg"], p["wo"], cfg,
                          capacity_factor)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xt, act=cfg.act)
    return y.reshape(*lead, d), aux


def _experts(xt, router, wi, wg, wo, cfg: ModelConfig, capacity_factor,
             block=None):
    """The routed experts' output (T, d) and aux over all T tokens xt.
    Off a mesh ``wi``/``wg``/``wo`` are all the experts' weights.  On
    one, ``block`` = (e0, c0, C) says which part of the (E, C, d)
    dispatch buffer this device holds: experts ``e0 ..`` (as many as
    ``wi`` has) and capacity slots ``c0 .. c0 + C - 1``; the weights may
    hold a block of the FFN's hidden dim too.  Pairs outside the block
    add nothing, so the output is this device's partial sum."""
    K = cfg.moe.top_k
    T, d = xt.shape
    r = route({"router": router}, xt, cfg, capacity_factor)
    flat_e = r.gate_idx.reshape(-1)
    flat_t = torch.arange(T, device=xt.device).repeat_interleave(K)
    keep, slot, C = r.keep, r.slot, r.capacity
    if block is not None:
        e0, c0, C = block
        mine = ((flat_e >= e0) & (flat_e < e0 + wi.shape[0])
                & (slot >= c0) & (slot < c0 + C))
        keep = keep & mine
        flat_e = torch.where(mine, flat_e - e0, 0)
        slot = torch.where(mine, slot - c0, 0)

    buf = torch.zeros(wi.shape[0], C, d, dtype=xt.dtype, device=xt.device)
    contrib = torch.where(keep[:, None], xt[flat_t], 0).to(xt.dtype)
    buf.index_put_((flat_e, slot), contrib, accumulate=True)
    buf = shard_act(buf, ("expert", "capacity", "act_embed"))
    h = F.silu(torch.bmm(buf, wi)) * torch.bmm(buf, wg)
    out_buf = torch.bmm(h, wo)                                # (E, C, d)
    out_buf = shard_act(out_buf, ("expert", "capacity", "act_embed"))

    w = torch.where(keep, r.gate_w.reshape(-1), 0.0).to(xt.dtype)
    weighted = (out_buf[flat_e, slot] * w[:, None]).reshape(T, K, d)
    y = weighted[:, 0]
    for k in range(1, K):
        y = y + weighted[:, k]
    return y, r.aux


def _sharded_experts(p, xt, cfg: ModelConfig, capacity_factor):
    """``_experts`` on a mesh.  Every device routes all T tokens
    (gathered), as the reference routes them globally (C is T's), and
    computes only its block of the dispatch buffer and of the FFN: the
    expert dim and the FFN's hidden dim stay sharded as the weights are,
    the capacity dim is split as the rules lay out the buffer
    (``("expert", "capacity", "act_embed")``) over the mesh dims left,
    and the rest of each weight is gathered.  Its output is then a
    partial sum over the devices that split any of these; aux, the same
    on each of them, is divided among them, and the gradients of the
    gathered tokens and router are partial sums alike."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import context, rules

    mesh = xt.device_mesh
    # (expert, embed, mlp) and (expert, mlp, embed): keep expert and mlp
    wiw = local.keep_shards(p["wi"], (0, 2))
    wow = tuple(Shard(1) if q.is_shard(2) else q for q in wiw)
    wi, wg = (local.laid_out(p[n], wiw) for n in ("wi", "wg"))
    wo = local.laid_out(p["wo"], wow)
    split = {i for i, q in enumerate(wiw) if q.is_shard()}
    E, C, d = p["wi"].shape[0], capacity(xt.shape[0], cfg,
                                         capacity_factor), xt.shape[1]
    buf = (Shard(0),) * mesh.ndim
    ctx = context.current()
    if ctx is not None:
        buf = rules.placements(mesh, rules.logical_to_spec(
            mesh, ("expert", "capacity", "act_embed"), (E, C, d), ctx[1]))
    # capacity over the mesh dims the weights do not split
    bw = tuple(Shard(1) if q.is_shard(1) and i not in split
               else wiw[i] if wiw[i].is_shard(0) else Replicate()
               for i, q in enumerate(buf))
    cap = {i for i, q in enumerate(bw) if q.is_shard(1)}
    e0 = local.global_offset((E, C, d), mesh, bw, 0)
    c0 = local.global_offset((E, C, d), mesh, bw, 1)
    C_loc = C // math.prod(mesh.size(i) for i in cap) if cap else C
    parts = split | cap
    n = math.prod(mesh.size(i) for i in parts)
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if i in parts else Replicate()
                 for i in range(mesh.ndim))
    xr, router = (local.laid_out(t, rep) for t in (xt, p["router"]))
    # a weight's gradient: its own shards, partial over the capacity split
    g_i, g_o = (tuple(Partial() if i in cap else q for i, q in enumerate(w))
                for w in (wiw, wow))

    def run(xl, rl, wil, wgl, wol):
        y, aux = _experts(xl, rl, wil, wgl, wol, cfg, capacity_factor,
                          (e0, c0, C_loc))
        return y, aux / n

    y, aux = local_map(run, out_placements=(part, part),
                       in_placements=(rep, rep, wiw, wiw, wow),
                       in_grad_placements=(part, part, g_i, g_i, g_o),
                       device_mesh=mesh)(xr, router, wi, wg, wo)
    # partial sums reduced first, then cut to the tokens' blocks: a
    # direct partial-to-shard step has a backward (shard to partial)
    # that some torch releases lack
    y = local.laid_out(local.laid_out(y, rep), xt.placements)
    return y, local.laid_out(aux, rep)
