"""Grouped-query attention: full-sequence (train / encode / prefill) and
cached single-token decode (``repro.models.attention``).

Parameters keep the JAX package's layouts: wq (d, H, hd), wk/wv
(d, KV, hd), wo (H, hd, d).  Full-sequence attention goes through
``kernels.flash_attention.flash_attention``: the CUDA kernel on the
card, its plain version on the CPU.  (The JAX engine computes the same
function with ``attn_impl="xla"``; the port puts it on the kernel.)

Decode attends one new token to a KV cache (B, T, KV, hd).  The JAX
package computes it with XLA (``_sdpa_chunked``), outside any Pallas
kernel, so here it stays plain PyTorch, with the reference's casts: the
q k^T product in the activations' type then f32, softcap and softmax
in f32, the weights cast to v's type for the second product.  A
sliding-window layer's cache is a ring of ``window`` slots with slot ==
absolute position % window; RoPE is applied at write time, so the ring's
order does not matter (validity is masked from absolute positions).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import NEG_INF, flash_attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_mrope, apply_rope, head_proj,
                                       trunc_normal)
from repro_torch.sharding import local
from repro_torch.sharding.context import is_dtensor, shard_act


def init_attention(gen, cfg: ModelConfig, dtype=torch.float32):
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    p = {"wq": trunc_normal((d, H, hd), s, gen, dtype),
         "wk": trunc_normal((d, KV, hd), s, gen, dtype),
         "wv": trunc_normal((d, KV, hd), s, gen, dtype),
         "wo": trunc_normal((H, hd, d), 1.0 / math.sqrt(H * hd), gen, dtype)}
    if cfg.attn.qkv_bias:
        p["bq"] = torch.zeros(H, hd, dtype=dtype)
        p["bk"] = torch.zeros(KV, hd, dtype=dtype)
        p["bv"] = torch.zeros(KV, hd, dtype=dtype)
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def attention_logical(cfg: ModelConfig) -> dict:
    """Logical axes of ``init_attention``'s leaves."""
    out = {"wq": ("embed", "heads", "head_dim"),
           "wk": ("embed", "kv_heads", "head_dim"),
           "wv": ("embed", "kv_heads", "head_dim"),
           "wo": ("heads", "head_dim", "embed")}
    if cfg.attn.qkv_bias:
        out.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                   bv=("kv_heads", "head_dim"))
    return out


KV_CACHE_LOGICAL = {"k": ("batch", "cache", "kv_heads", "head_dim"),
                    "v": ("batch", "cache", "kv_heads", "head_dim")}


def _out_proj(out, wo):
    """out (B, S, H, hd) by wo (H, hd, d) -> (B, S, d); on a mesh with
    both flattened (H * hd) dims pinned by their heads, as in
    ``layers.head_proj`` (the gradient of ``out`` unflattens)."""
    if not local.any_sharded(out, wo):
        return torch.einsum("...hk,hkd->...d", out, wo)
    H = wo.shape[0]
    of = shard_act(out.flatten(-2), ("batch", "seq", "heads"),
                   dim_sizes=(*out.shape[:-2], H))
    wf = shard_act(wo.flatten(0, 1), ("heads", "embed"),
                   dim_sizes=(H, wo.shape[-1]))
    return of @ wf


def _project_qkv(p, x, cfg: ModelConfig, positions):
    q = head_proj(x, p["wq"], "heads")
    k = head_proj(x, p["wk"], "kv_heads")
    v = head_proj(x, p["wv"], "kv_heads")
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    a = cfg.attn
    if a.use_mrope:
        q = apply_mrope(q, positions, a.mrope_sections, a.rope_theta)
        k = apply_mrope(k, positions, a.mrope_sections, a.rope_theta)
    elif a.rope_theta > 0:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    q = shard_act(q, ("batch", "seq", "heads", "head_dim"))
    k = shard_act(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = shard_act(v, ("batch", "seq", "kv_heads", "head_dim"))
    return q, k, v


def attend_full(p, x, cfg: ModelConfig, positions, window: int = 0):
    """Full-sequence attention over x (B, S, d).  Returns ((B, S, d),
    (k, v)): the keys and values (B, S, KV, hd), after RoPE, that a
    prefill keeps as its cache.  On a mesh each device runs the kernel
    on its shards (``sharding.local.attention_on_shards``)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    a = cfg.attn

    def attend(q, k, v):
        return flash_attention(q, k, v, causal=a.causal, window=window,
                               softcap=a.softcap)

    out = (local.attention_on_shards(attend, q, k, v) if is_dtensor(q)
           else attend(q, k, v))
    out = shard_act(out, ("batch", "seq", "heads", "head_dim"))
    return _out_proj(out, p["wo"]), (k, v)


def init_kv_cache(batch: int, max_len: int, cfg: ModelConfig, dtype,
                  device=None) -> dict:
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, max_len, KV, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_cache_from_kv(k, v, window: int, dtype, capacity=None) -> dict:
    """The decode cache from a prefill's (B, S, KV, hd) keys and values.

    A full-attention layer keeps ``capacity`` slots (default S; pass S +
    the tokens still to decode), zero past S; a capacity below S keeps
    all S, as the reference does.  A window layer keeps the ring of
    ``window`` slots with slot == absolute position % window:
    zero-padded when S < window, else the last ``window`` positions
    rolled by S % window.  On a mesh each device lays out its own block
    of the batch and heads (``sharding.local.along_seq``)."""
    S = k.shape[1]
    if window <= 0:
        cap = max(capacity or S, S)
    elif S <= window:
        cap = window
    else:
        shift = S % window

        def ring(t):
            return torch.roll(t[:, -window:], shift, 1).to(dtype)

        return {"k": local.along_seq(ring, k), "v": local.along_seq(ring, v)}
    pad = (0, 0, 0, 0, 0, cap - S)

    def padded(t):
        return nn.functional.pad(t, pad).to(dtype)

    return {"k": local.along_seq(padded, k), "v": local.along_seq(padded, v)}


def _repeat_kv(k, v, H: int):
    G = H // k.shape[2]
    if G == 1:
        return k, v
    return k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)


def attend_decode(p, x, cache: dict, index: int, cfg: ModelConfig,
                  positions, window: int = 0):
    """One token x (B, 1, d) at absolute position ``index`` against the
    cache k/v (B, T, KV, hd).  Returns ((B, 1, d), a new cache with the
    token's k/v at slot index % T); the given cache is left as it is,
    as in the JAX package."""
    q, k1, v1 = _project_qkv(p, x, cfg, positions)
    T = cache["k"].shape[1]
    w = index % T
    # a select, not a cat of slices: on a mesh the slot dim may be
    # sharded, and DTensor's slices of a sharded dim are not safe
    at = (torch.arange(T, device=x.device) == w)[None, :, None, None]
    k, v = (torch.where(at, new.to(c.dtype), c)
            for c, new in ((cache["k"], k1), (cache["v"], v1)))

    def attend(q, k, v):
        return _decode_attention(q, k, v, index, window, cfg.attn.softcap)

    out = (local.attention_on_shards(attend, q, k, v) if is_dtensor(q)
           else attend(q, k, v))
    out = shard_act(out, ("batch", "seq", "heads", "head_dim"))
    return _out_proj(out, p["wo"]), {"k": k, "v": v}


def _decode_attention(q, k, v, index: int, window: int, softcap: float):
    """The attention of ``attend_decode`` over the whole cache k/v
    (B, T, KV, hd), in the reference's casts.  On a mesh each device
    runs it on its shards (``sharding.local.attention_on_shards``), as
    the full-sequence kernel does."""
    T = k.shape[1]
    kr, vr = _repeat_kv(k, v, q.shape[2])
    kj = torch.arange(T, device=q.device)
    ok = (kj <= index) | (index >= T)
    if 0 < window < T:
        ok &= kj > index - window
    bias = torch.where(ok, 0.0, NEG_INF)
    scale = 1.0 / math.sqrt(q.shape[-1])
    # the reference's casts: the product in the activations' type, then
    # f32 for the scale, softcap and softmax, and back to v's type
    s = torch.einsum("bshd,bthd->bhst", q, kr).float()
    s = shard_act(s, ("batch", "heads", "seq", "seq")) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    probs = torch.softmax(s + bias, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(vr.dtype), vr)


def layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    """Sliding-window size of a layer under the config's pattern."""
    a = cfg.attn
    if a.sliding_window <= 0:
        return 0
    if a.window_pattern == "all_local":
        return a.sliding_window
    if a.window_pattern == "gemma":
        return (0 if layer_idx % a.global_every == a.global_every - 1
                else a.sliding_window)
    if a.window_pattern == "starcoder_swa":
        return a.sliding_window
    return 0
