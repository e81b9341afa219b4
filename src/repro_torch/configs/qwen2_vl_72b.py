"""Qwen2-VL-72B language backbone [arXiv:2409.12191].

Copied from ``repro.configs.qwen2_vl_72b``.

VLM: the SigLIP-style ViT frontend + merger is a stub —
``launch.specs.batch_specs`` supplies precomputed patch+text embeddings
(B, S, d).  The backbone uses
M-RoPE (temporal/height/width sections) and QKV bias, per the paper.
"""

from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    attn=AttnConfig(rope_theta=1_000_000.0, use_mrope=True,
                    mrope_sections=(16, 24, 24), qkv_bias=True),
    layer_pattern=("attn",),
    moe_pattern=(False,),
    tie_embeddings=False,
    source="arXiv:2409.12191",
)
