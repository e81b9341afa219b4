"""Full-sequence grouped-query attention for the dense encoder.

Parameters keep the JAX package's layouts: wq (d, H, hd), wk/wv
(d, KV, hd), wo (H, hd, d).  The attention itself goes through
``kernels.flash_attention.flash_attention``: the CUDA kernel on the
card, its plain version on the CPU.  (The JAX engine computes the same
function with ``attn_impl="xla"``; the port puts it on the kernel.)
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import apply_rope, trunc_normal


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


def _project_qkv(p, x, cfg: ModelConfig, positions):
    q = torch.einsum("...d,dhk->...hk", x, p["wq"])
    k = torch.einsum("...d,dhk->...hk", x, p["wk"])
    v = torch.einsum("...d,dhk->...hk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.attn.rope_theta > 0:
        q = apply_rope(q, positions, cfg.attn.rope_theta)
        k = apply_rope(k, positions, cfg.attn.rope_theta)
    return q, k, v


def attend_full(p, x, cfg: ModelConfig, positions, window: int = 0):
    """Full-sequence attention over x (B, S, d); returns (B, S, d)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    a = cfg.attn
    out = flash_attention(q, k, v, causal=a.causal, window=window,
                          softcap=a.softcap)
    return torch.einsum("...hk,hkd->...d", out, p["wo"])


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
