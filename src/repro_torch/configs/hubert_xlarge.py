"""HuBERT-XLarge [arXiv:2106.07447].

Copied from ``repro.configs.hubert_xlarge``.

Encoder-only (bidirectional, no decode shapes).  The mel/conv feature
extractor frontend is a stub: ``launch.specs.batch_specs`` supplies
precomputed frame embeddings (B, T, d).  Targets are 504 k-means
cluster ids (masked prediction), so vocab=504 and the head is untied.
"""

from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    attn=AttnConfig(rope_theta=0.0, causal=False),  # conv-pos stub, bidirectional
    layer_pattern=("attn",),
    moe_pattern=(False,),
    is_encoder=True,
    tie_embeddings=False,
    norm_kind="layernorm",
    act="gelu",
    embed_inputs=False,
    source="arXiv:2106.07447",
)
