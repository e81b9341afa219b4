"""A plain pre-norm transformer in float32: the math both references
share, written from the layer equations and nothing of the program.

Layer: ``x + attn(LN1(x))``, then ``x + mlp(LN2(x))``; layernorm with a
scale and a bias; grouped-query attention (query head ``h`` reads key
head ``h // (H / KV)``), split-half RoPE on q and k, optional q/k/v
biases, softmax over the keys that the causal mask and the window
leave; the MLP is ``gelu_tanh(x wi) wo``; the final layernorm, then
logits against the tied embedding table.

Weights are a dict of tensors keyed as the benchmark makes them
(``param_specs``): ``embed.table`` (V, d); per layer ``layers.{i}.``
``norm1.scale``, ``norm1.bias``, ``mix.wq`` (d, H, hd), ``mix.wk`` and
``mix.wv`` (d, KV, hd), ``mix.wo`` (H, hd, d), with biases ``mix.bq``
(H, hd), ``mix.bk``, ``mix.bv`` (KV, hd), ``norm2.scale``,
``norm2.bias``, ``mlp.wi`` (d, ff), ``mlp.wo`` (ff, d); ``final_norm.``
``scale`` and ``bias``.  Any type: each layer's weights are read as
float32 when the layer runs, so a model larger than float32 memory
allows runs one layer at a time.  Every product goes through a
``precision.Products``, which is exact float32 in the reference and
rounds its operands in a control.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from reference.precision import Products


@dataclasses.dataclass(frozen=True)
class Shape:
    layers: int
    d: int
    heads: int
    kv_heads: int
    ff: int
    vocab: int
    rope_theta: float
    causal: bool
    window: int = 0          # 0: every key the causal mask leaves
    eps: float = 1e-6
    qkv_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.d // self.heads


def param_specs(s: Shape, prefix: str = "") -> list:
    """(name, shape, role) of every weight; role is ``("matrix", fan_in)``,
    ``("embed", d)``, ``("scale",)`` or ``("bias",)``."""
    d, H, KV, hd, ff = s.d, s.heads, s.kv_heads, s.head_dim, s.ff
    out = [(f"{prefix}embed.table", (s.vocab, d), ("embed", d))]
    for i in range(s.layers):
        p = f"{prefix}layers.{i}."
        out += [(p + "norm1.scale", (d,), ("scale",)),
                (p + "norm1.bias", (d,), ("bias",)),
                (p + "mix.wq", (d, H, hd), ("matrix", d)),
                (p + "mix.wk", (d, KV, hd), ("matrix", d)),
                (p + "mix.wv", (d, KV, hd), ("matrix", d)),
                (p + "mix.wo", (H, hd, d), ("matrix", H * hd))]
        if s.qkv_bias:
            out += [(p + "mix.bq", (H, hd), ("bias",)),
                    (p + "mix.bk", (KV, hd), ("bias",)),
                    (p + "mix.bv", (KV, hd), ("bias",))]
        out += [(p + "norm2.scale", (d,), ("scale",)),
                (p + "norm2.bias", (d,), ("bias",)),
                (p + "mlp.wi", (d, ff), ("matrix", d)),
                (p + "mlp.wo", (ff, d), ("matrix", ff))]
    out += [(f"{prefix}final_norm.scale", (d,), ("scale",)),
            (f"{prefix}final_norm.bias", (d,), ("bias",))]
    return out


def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def rope(x, theta):
    """Split-half RoPE over x (S, heads, hd) at positions 0..S-1."""
    S, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, s: Shape, P: Products):
    """One sequence: q (S, H, hd), k and v (S, KV, hd) -> (S, H, hd)."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    scores = P.einsum("shd,thd->hst", q, k) / math.sqrt(hd)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if s.causal:
        ok &= kj <= qi
    if s.window > 0:
        ok &= kj > qi - s.window
    scores = scores.masked_fill(~ok, float("-inf"))
    return P.einsum("hst,thd->shd", torch.softmax(scores, dim=-1), v)


def block(w, p: str, x, s: Shape, P: Products):
    """Layer ``p`` (a name prefix) over x (B, S, d) float32."""
    d, H, KV, hd = s.d, s.heads, s.kv_heads, s.head_dim
    wq = w[p + "mix.wq"].float().reshape(d, H * hd)
    wk = w[p + "mix.wk"].float().reshape(d, KV * hd)
    wv = w[p + "mix.wv"].float().reshape(d, KV * hd)
    wo = w[p + "mix.wo"].float().reshape(H * hd, d)
    wi, wo2 = w[p + "mlp.wi"].float(), w[p + "mlp.wo"].float()
    B, S = x.shape[:2]
    h = layer_norm(x, w[p + "norm1.scale"], w[p + "norm1.bias"], s.eps)
    q = P.mm(h, wq).reshape(B, S, H, hd)
    k = P.mm(h, wk).reshape(B, S, KV, hd)
    v = P.mm(h, wv).reshape(B, S, KV, hd)
    if s.qkv_bias:
        q = q + w[p + "mix.bq"].float()
        k = k + w[p + "mix.bk"].float()
        v = v + w[p + "mix.bv"].float()
    att = torch.stack([attention(rope(q[b], s.rope_theta),
                                 rope(k[b], s.rope_theta), v[b], s, P)
                       for b in range(B)])
    x = x + P.mm(att.reshape(B, S, H * hd), wo)
    h2 = layer_norm(x, w[p + "norm2.scale"], w[p + "norm2.bias"], s.eps)
    return x + P.mm(F.gelu(P.mm(h2, wi), approximate="tanh"), wo2)


def hidden(w, s: Shape, tokens, P: Products, prefix: str = ""):
    """Final-norm hidden states (B, S, d) float32 for tokens (B, S)."""
    x = w[f"{prefix}embed.table"][tokens.long()].float()
    for i in range(s.layers):
        x = block(w, f"{prefix}layers.{i}.", x, s, P)
    return layer_norm(x, w[f"{prefix}final_norm.scale"],
                      w[f"{prefix}final_norm.bias"], s.eps)


def logits(w, h, P: Products, prefix: str = ""):
    """Logits (..., V) of hidden states h (..., d) against the tied
    embedding table."""
    return P.mm(h, w[f"{prefix}embed.table"].float().t())
