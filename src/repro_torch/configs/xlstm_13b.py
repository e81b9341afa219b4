"""xLSTM-1.3B [arXiv:2405.04517], copied from ``repro.configs.xlstm_13b``.

xLSTM[7:1]: repeating 8-layer unit of 7 mLSTM blocks + 1 sLSTM block.
d_ff=0: blocks carry their own internal up/down projections (mLSTM
pf=2) and there is no separate MLP.  The mLSTM's q/k/v projections are
full (di, H, dh) ones, as in the JAX package, so this config holds
3,426,709,840 parameters.
"""

from repro_torch.models.common import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attn=AttnConfig(rope_theta=0.0),
    ssm=SSMConfig(kind="mlstm", num_heads=4, expand=2),
    layer_pattern=("mlstm", "mlstm", "mlstm", "mlstm",
                   "mlstm", "mlstm", "mlstm", "slstm"),
    moe_pattern=(False,) * 8,
    tie_embeddings=True,
    norm_kind="layernorm",
    source="arXiv:2405.04517",
)
