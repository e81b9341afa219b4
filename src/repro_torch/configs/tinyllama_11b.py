"""TinyLlama-1.1B [arXiv:2401.02385]. Llama-2 architecture, GQA kv=4.

Copied from ``repro.configs.tinyllama_11b``.
"""

from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    attn=AttnConfig(rope_theta=10000.0),
    layer_pattern=("attn",),
    moe_pattern=(False,),
    tie_embeddings=False,
    source="arXiv:2401.02385",
)
