"""Jamba-v0.1 52B hybrid [arXiv:2403.19887].

Repeating 8-layer unit, attention:mamba = 1:7 (attention at in-unit index
4), MoE MLP every other layer (16 experts, top-2).  Copied from
``repro.configs.jamba_v01_52b``.
"""

from repro_torch.models.common import (AttnConfig, ModelConfig, MoEConfig,
                                      SSMConfig)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    attn=AttnConfig(rope_theta=0.0),   # Jamba uses no positional encoding
    moe=MoEConfig(num_experts=16, top_k=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe_pattern=(False, True, False, True, False, True, False, True),
    tie_embeddings=False,
    source="arXiv:2403.19887",
)
