"""Grok-1 314B MoE [hf:xai-org/grok-1]. 8 experts, top-2; GQA kv=8.

Copied from ``repro.configs.grok1_314b``.
"""

from repro_torch.models.common import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    attn=AttnConfig(rope_theta=10000.0, softcap=30.0),
    moe=MoEConfig(num_experts=8, top_k=2),
    layer_pattern=("attn",),
    moe_pattern=(True,),
    tie_embeddings=True,
    embed_scale=True,
    source="hf:xai-org/grok-1",
)
