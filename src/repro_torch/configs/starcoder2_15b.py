"""StarCoder2-15B [arXiv:2402.19173].

Copied from ``repro.configs.starcoder2_15b``.

GQA kv=4, RoPE, native 4096-token sliding-window attention on every layer
(which is what qualifies it for the long_500k decode shape).
"""

from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    attn=AttnConfig(rope_theta=100_000.0, qkv_bias=True,
                    sliding_window=4096, window_pattern="all_local"),
    layer_pattern=("attn",),
    moe_pattern=(False,),
    tie_embeddings=True,
    norm_kind="layernorm",
    act="gelu",
    source="arXiv:2402.19173",
)
