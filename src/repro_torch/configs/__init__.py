"""Architecture configs of the JAX package's zoo that the port runs.

``get_config(name)`` resolves an id or alias as ``repro.configs`` does;
``list_archs()`` lists the ported ids.  Ported: the dense decoders
(tinyllama-1.1b, qwen1.5-0.5b, starcoder2-15b, gemma3-4b), the
bidirectional audio encoder hubert-xlarge, the qwen2-vl-72b backbone
(mRoPE, fed embeddings) and xlstm-1.3b.  The rest need blocks the port
does not have yet and raise, pointing at ``ROADMAP.md`` queue 1, item
14: jamba-v0.1-52b (Mamba and MoE), then qwen2-moe-a2.7b and
grok-1-314b (``models/moe.py``).
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

PORTED = ("qwen2_vl_72b", "qwen15_05b", "hubert_xlarge", "tinyllama_11b",
          "starcoder2_15b", "xlstm_13b", "gemma3_4b")


def get_config(name: str):
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"{name}: not ported yet; the port runs {list(PORTED)}.  "
            f"ROADMAP.md queue 1, item 14 lists the rest in order: "
            f"jamba_v01_52b (Mamba and MoE blocks), then qwen2_moe_a27b and "
            f"grok1_314b (models/moe.py)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def list_archs() -> list:
    """The ids of the ported architectures, in the JAX package's order."""
    return list(PORTED)

