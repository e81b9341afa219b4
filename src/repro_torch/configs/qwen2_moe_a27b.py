"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts (top-4, d_ff 1408 each) + 4 shared experts.
Copied from ``repro.configs.qwen2_moe_a27b``.
"""

from repro_torch.models.common import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    attn=AttnConfig(rope_theta=1_000_000.0, qkv_bias=True),
    moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4),
    layer_pattern=("attn",),
    moe_pattern=(True,),
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
