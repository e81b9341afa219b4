"""Architecture configs of the JAX package's zoo, all ten ported.

``get_config(name)`` resolves an id or alias as ``repro.configs`` does;
``list_archs()`` lists the ids in the JAX package's order: the dense
decoders (tinyllama-1.1b, qwen1.5-0.5b, starcoder2-15b, gemma3-4b),
the bidirectional audio encoder hubert-xlarge, the qwen2-vl-72b
backbone (mRoPE, fed embeddings), the MoE decoders qwen2-moe-a2.7b
(shared experts) and grok-1-314b (softcap), the Mamba/attention/MoE
hybrid jamba-v0.1-52b and xlstm-1.3b.
"""

from __future__ import annotations

import importlib

# the JAX package's alias table
_ALIASES = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "qwen1.5-0.5b": "qwen15_05b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "grok-1-314b": "grok1_314b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "hubert-xlarge": "hubert_xlarge",
    "tinyllama-1.1b": "tinyllama_11b",
    "starcoder2-15b": "starcoder2_15b",
    "xlstm-1.3b": "xlstm_13b",
    "gemma3-4b": "gemma3_4b",
}

# the JAX package's ARCH_IDS, in its order
PORTED = ("qwen2_vl_72b", "qwen15_05b", "jamba_v01_52b", "grok1_314b",
          "qwen2_moe_a27b", "hubert_xlarge", "tinyllama_11b",
          "starcoder2_15b", "xlstm_13b", "gemma3_4b")


def get_config(name: str):
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    if mod_name not in PORTED:
        raise ValueError(f"{name}: not an architecture of the zoo "
                         f"{list(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def list_archs() -> list:
    """The ids of the zoo's architectures, in the JAX package's order."""
    return list(PORTED)
