"""Architecture configs of the JAX package's zoo that the port runs.

``get_config(name)`` resolves an id or alias as ``repro.configs`` does.
Only ported architectures are registered; any other id raises and
points at ``ROADMAP.md``.
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

PORTED = ("xlstm_13b",)


def get_config(name: str):
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"{name}: not ported yet; the port runs {list(PORTED)} "
            f"(ROADMAP.md queue 1, item 14 lists the rest of the zoo)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG

