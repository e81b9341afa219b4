"""Plain reference of StarCoder2-15B as the port serves it
(``starcoder2-15b``): a causal pre-norm decoder with grouped-query
attention over a 4,096-token window, RoPE (theta 1e5), layernorm,
GELU (tanh) MLP, q/k/v biases and tied embeddings
(``transformer``), in float32 with the model's bfloat16 weights read as
float32 one layer at a time, so that it fits beside the served model.

A served token is judged by the full forward pass over the prompt and
the tokens served before it: the logits at the position before it.
"""

from __future__ import annotations

import torch

from reference import transformer as T
from reference.precision import Products


def shape(cfg: dict) -> T.Shape:
    return T.Shape(layers=cfg["num_hidden_layers"], d=cfg["hidden_size"],
                   heads=cfg["num_attention_heads"],
                   kv_heads=cfg["num_key_value_heads"],
                   ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                   rope_theta=cfg["rope_theta"], causal=True,
                   window=cfg["sliding_window"], eps=cfg["norm_epsilon"],
                   qkv_bias=cfg["use_bias"] == "qkv")


def param_specs(cfg: dict) -> list:
    return T.param_specs(shape(cfg))


@torch.no_grad()
def logits_at(w, cfg: dict, tokens: torch.Tensor, positions, P: Products):
    """Logits (N, len(positions), V) float32 at ``positions`` of the
    sequences tokens (N, L)."""
    h = T.hidden(w, shape(cfg), tokens, P)
    return T.logits(w, h[:, list(positions)], P)
