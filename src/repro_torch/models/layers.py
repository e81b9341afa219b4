"""Functional NN primitives on tensors, in the JAX package's layouts.

Each ``apply_*`` takes a mapping of parameter tensors (a plain dict or
an ``nn.ParameterDict``) keyed as in ``repro.models.layers``, so the
same functions serve the modules of ``models.model`` and the parity
tests.  ``init_*`` build those ``nn.ParameterDict``s from a
``torch.Generator``, on the device that is current (``with device:``)
and that the generator lives on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import local
from repro_torch.sharding.context import is_dtensor, shard_act


def trunc_normal(shape, scale: float, gen: torch.Generator,
                 dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2] (the JAX
    package's ``_init``)."""
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def _params(**tensors) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


# ---------------------------------------------------------------- norms

def init_norm(d: int, kind: str = "rmsnorm") -> nn.ParameterDict:
    p = {"scale": torch.ones(d)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d)
    return _params(**p)


def norm_logical(kind: str = "rmsnorm") -> dict:
    """Logical axes of ``init_norm``'s leaves (``sharding.rules``)."""
    return {k: ("norm",) for k in
            (("scale", "bias") if kind == "layernorm" else ("scale",))}


def apply_norm(p, x, eps: float = 1e-6, kind: str = "rmsnorm"):
    """Layernorm or RMSnorm, computed in f32 and cast back to x's type."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------- dense

def init_dense(gen, d_in: int, d_out: int, dtype=torch.float32,
               bias: bool = False) -> nn.ParameterDict:
    p = {"w": trunc_normal((d_in, d_out), 1.0 / math.sqrt(d_in), gen, dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype)
    return _params(**p)


def dense_logical(axes=("embed", "mlp"), bias: bool = False) -> dict:
    out = {"w": tuple(axes)}
    if bias:
        out["b"] = (axes[-1],)
    return out


def apply_dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ------------------------------------------------------------ embedding

def init_embedding(gen, vocab: int, d: int, dtype=torch.float32):
    # 1/sqrt(d) keeps tied-unembed logits O(1) at init
    return _params(table=trunc_normal((vocab, d), 1.0 / math.sqrt(d), gen,
                                      dtype))


EMBEDDING_LOGICAL = {"table": ("vocab", "embed")}


def apply_embedding(p, ids):
    if is_dtensor(ids):
        return local.embedding_on_shards(p["table"], ids)
    return p["table"][ids.long()]


def apply_unembed(p, x):
    return x @ p["table"].t()


# ----------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """Split-half RoPE.  x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    ang = positions[..., None].float() * freqs                # (..., S, d/2)
    ang = ang[..., None, :]                                   # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, sections, theta: float = 10000.0):
    """Qwen2-VL's multimodal RoPE, split-half, in f32.  x: (..., S, H,
    D); positions3: (3, ..., S) temporal / height / width ids.  The D/2
    frequency slots fall into ``sections`` (t, h, w), the last section
    taking any slots past their sum; each slot turns by its section's
    position.  For text the three streams are equal and this is RoPE."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    bounds = torch.cumsum(torch.tensor((0,) + tuple(sections),
                                       device=x.device), 0)
    slot = torch.arange(d // 2, device=x.device)
    which = (torch.searchsorted(bounds, slot, right=True) - 1).clamp(0, 2)
    pos = positions3.float()[which]                           # (d/2, ..., S)
    ang = pos.movedim(0, -1) * freqs                          # (..., S, d/2)
    ang = ang[..., None, :]                                   # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ mlp

def init_mlp(gen, d_model: int, d_ff: int, dtype=torch.float32,
             act: str = "silu") -> nn.ParameterDict:
    # draw order follows the JAX package's key split: wi, wg, wo
    wi = trunc_normal((d_model, d_ff), 1 / math.sqrt(d_model), gen, dtype)
    wg = trunc_normal((d_model, d_ff), 1 / math.sqrt(d_model), gen, dtype)
    wo = trunc_normal((d_ff, d_model), 1 / math.sqrt(d_ff), gen, dtype)
    if act == "silu":  # swiglu
        return _params(wi=wi, wg=wg, wo=wo)
    return _params(wi=wi, wo=wo)


def mlp_logical(act: str = "silu") -> dict:
    out = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
           "wo": ("mlp", "embed")}
    if act != "silu":
        del out["wg"]
    return out


def head_proj(x, w, heads: str):
    """x (B, S, d) by w (d, h, k) -> (B, S, h, k).  On a mesh as one
    product with w flattened to (d, h * k) into (B, S, h * k), both
    flattened dims pinned by their heads (logical axis ``heads``), then
    unflattened: DTensor may shard a flattened dim that its heads do
    not divide, and then cannot unflatten it, in the forward or in the
    weight's gradient (4 kv heads of 64 on a 16-way axis).  Where
    nothing is sharded (a (1, 1) mesh) the meshless product runs."""
    if not local.any_sharded(x, w):
        return torch.einsum("...d,dhk->...hk", x, w)
    wf = shard_act(w.flatten(1), ("embed", heads), dim_sizes=w.shape[:2])
    y = shard_act(x @ wf, ("batch", "seq", heads),
                  dim_sizes=(*x.shape[:-1], w.shape[1]))
    return y.unflatten(-1, w.shape[1:])


def apply_mlp(p, x, act: str = "silu"):
    """SwiGLU when ``wg`` is present; else a plain MLP whose GELU is the
    tanh approximation (``jax.nn.gelu``'s default, not torch's)."""
    h = x @ p["wi"]
    if "wg" in p:
        h = F.silu(h) * (x @ p["wg"])
    else:
        h = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    return h @ p["wo"]
