"""Model configuration of every architecture family of the zoo: dense
encoders and decoders, MoE, the xLSTM family and the Mamba hybrid.

The fields are ported from ``repro.models.common``: attention with
RoPE or Qwen2-VL's mRoPE, sliding windows and softcap; the MoE MLP's
``moe`` (``MoEConfig``); the recurrent blocks' ``ssm``; the
repeating-unit patterns ``layer_pattern`` / ``moe_pattern``; the
modality stub ``embed_inputs``; and the metadata ``max_seq_len`` and
``source``.  ``torch_dtype`` takes the place of ``jnp_dtype``.
``InputShape`` and ``INPUT_SHAPES`` are the benchmark shapes
``launch.specs`` judges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0          # per-expert hidden; 0 -> use model d_ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"           # "mamba" | "mlstm" | "slstm"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    num_heads: int = 4            # for m/sLSTM


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    rope_theta: float = 10000.0
    use_mrope: bool = False       # Qwen2-VL multimodal RoPE (3 sections)
    mrope_sections: tuple = (16, 24, 24)
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
    family: str = "dense"         # dense | moe | ssm | hybrid | vlm | audio
    moe: Optional[MoEConfig] = None
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
    # modality frontend stub: False -> the input is (B, S, d_model) floats
    embed_inputs: bool = True
    max_seq_len: int = 131072
    source: str = ""              # citation of the published config

    def __post_init__(self):
        if len(self.moe_pattern) != len(self.layer_pattern):
            raise ValueError(f"{self.name}: moe_pattern and layer_pattern "
                             f"differ in length")
        if any(self.moe_pattern) and self.moe is None:
            raise ValueError(f"{self.name}: moe_pattern marks MoE layers "
                             f"but moe is None")

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

    def reduced(self, num_layers=2, d_model=256,
                max_experts=4) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (the JAX
        package's ``reduced``)."""
        unit = len(self.layer_pattern)
        layers = max(num_layers, unit)
        layers -= layers % unit
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        d_model = min(d_model, 512)
        moe = None
        if self.moe is not None:
            ne = min(self.moe.num_experts, max_experts)
            moe = dataclasses.replace(
                self.moe,
                num_experts=ne,
                top_k=min(self.moe.top_k, ne),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_expert=(d_model * 2 if self.moe.d_ff_expert else 0),
            )
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
            moe=moe,
            ssm=ssm,
            dtype="float32",
            max_seq_len=2048,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the benchmark input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
