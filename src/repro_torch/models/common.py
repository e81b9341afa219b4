"""Model configuration: the dense encoder family and the xLSTM family.

The fields these two families read are ported from
``repro.models.common``: the dense bidirectional encoder's, and for the
recurrent family ``family``, ``ssm`` and the repeating-unit patterns
``layer_pattern`` / ``moe_pattern``.  MoE and mRoPE come with the rest
of the model zoo; a ``moe_pattern`` that marks any layer raises.
``family`` is read by no port code yet; it is carried so that a config
copy can be held against the JAX one field by field.  ``torch_dtype``
takes the place of ``jnp_dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """The recurrent blocks' widths: the fields of the JAX package's
    ``SSMConfig`` that mLSTM and sLSTM read (Mamba's come with Mamba)."""
    expand: int = 2
    num_heads: int = 4            # for m/sLSTM


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
    family: str = "dense"         # dense | ssm (the families ported so far)
    ssm: Optional[SSMConfig] = None
    # per-layer block kinds within one repeating unit; layers follow it
    # unit by unit, then the first num_layers % len(pattern) kinds
    layer_pattern: tuple = ("attn",)
    moe_pattern: tuple = (False,)  # same length as layer_pattern
    is_encoder: bool = False      # bidirectional, MLM-style
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm
    embed_scale: bool = False     # multiply embeddings by sqrt(d_model)
    act: str = "silu"             # silu (swiglu) | gelu (plain mlp)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.moe_pattern) != len(self.layer_pattern):
            raise ValueError(f"{self.name}: moe_pattern and layer_pattern "
                             f"differ in length")
        if any(self.moe_pattern):
            raise NotImplementedError(
                f"{self.name}: MoE layers are not ported yet (ROADMAP.md "
                f"queue 1, item 14)")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def num_units(self) -> int:
        if self.num_layers % len(self.layer_pattern):
            raise ValueError(f"{self.name}: {self.num_layers} layers not "
                             f"divisible by unit of {len(self.layer_pattern)}")
        return self.num_layers // len(self.layer_pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self, num_layers=2, d_model=256) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (the JAX
        package's ``reduced`` without its MoE and max_seq_len fields)."""
        unit = len(self.layer_pattern)
        layers = max(num_layers, unit)
        layers -= layers % unit
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        d_model = min(d_model, 512)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, num_heads=min(ssm.num_heads, 2))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=0,
            d_ff=d_model * 3,
            vocab_size=min(self.vocab_size, 512),
            ssm=ssm,
            dtype="float32",
        )
