"""Qwen1.5-0.5B dense decoder [hf:Qwen/Qwen1.5-0.5B]. QKV bias; MHA (kv=16).

Copied from ``repro.configs.qwen15_05b``.
"""

from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    attn=AttnConfig(rope_theta=1_000_000.0, qkv_bias=True),
    layer_pattern=("attn",),
    moe_pattern=(False,),
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
