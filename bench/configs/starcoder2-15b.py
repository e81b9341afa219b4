"""The system under test for ``starcoder2-15b.json``: the port's
``models.model.Model`` at the configuration's sizes, built on ``meta``
and given the benchmark's weights (``load_state_dict(assign=True)``:
the model serves the very tensors the reference reads)."""

from __future__ import annotations

import torch


def model_config(cfg: dict):
    from repro_torch.models.common import AttnConfig, ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        attn=AttnConfig(rope_theta=cfg["rope_theta"],
                        qkv_bias=cfg["use_bias"] == "qkv",
                        sliding_window=cfg["sliding_window"],
                        window_pattern="all_local"),
        tie_embeddings=cfg["tie_word_embeddings"], norm_kind="layernorm",
        norm_eps=cfg["norm_epsilon"], act="gelu", dtype=cfg["dtype"],
        max_seq_len=cfg["max_position_embeddings"], source=cfg["paper"])


def build(cfg: dict, ref, weights: dict, device) -> dict:
    """{"model"} on ``device``."""
    from repro_torch.models.model import Model
    with torch.device("meta"):
        model = Model(model_config(cfg), None)
    model.load_state_dict(weights, strict=True, assign=True)
    return {"model": model}
