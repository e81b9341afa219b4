"""Gemma-3-4B [hf:google/gemma-3-1b-pt family].

Copied from ``repro.configs.gemma3_4b``.

5:1 local(1024-window):global attention pattern, 128k context, head_dim
256, huge (262144) vocabulary, sqrt(d) embedding scaling.  34 layers = 5
full 6-layer units + 4 remainder (local) layers.
"""

from repro_torch.models.common import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    attn=AttnConfig(rope_theta=1_000_000.0, sliding_window=1024,
                    window_pattern="gemma", global_every=6),
    layer_pattern=("attn",) * 6,
    moe_pattern=(False,) * 6,
    tie_embeddings=True,
    embed_scale=True,
    max_seq_len=131072,
    source="hf:google/gemma-3-1b-pt",
)
