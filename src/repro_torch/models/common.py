"""Model configuration for the dense encoder family.

Only the fields the dense bidirectional encoder reads are ported from
``repro.models.common``; MoE, SSM, mRoPE and the layer-pattern machinery
come with the model zoo.  ``torch_dtype`` takes the place of
``jnp_dtype``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    rope_theta: float = 10000.0
    sliding_window: int = 0       # 0 = full attention
    # pattern of window use per layer: "all_global", "all_local",
    # "gemma" (5 local : 1 global) or "starcoder_swa"
    window_pattern: str = "all_global"
    global_every: int = 6         # for "gemma": layer % 6 == 5 is global
    qkv_bias: bool = False
    causal: bool = True
    softcap: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    attn: AttnConfig = AttnConfig()
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm
    embed_scale: bool = False     # multiply embeddings by sqrt(d_model)
    act: str = "silu"             # silu (swiglu) | gelu (plain mlp)
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)
