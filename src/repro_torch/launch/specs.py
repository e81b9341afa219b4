"""Input shapes and types of every (architecture x input shape) pair:
``repro.launch.specs`` without JAX's abstract arrays.  Each spec is a
``(shape, dtype)`` pair; nothing is allocated, so full-size configs can
be judged on any host.  For the VLM and audio families the modality
frontend is a stub: train and prefill batches carry precomputed
embeddings (B, S, d); decode takes text token ids.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import InputShape, ModelConfig


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether this (arch, shape) pair runs, and the skip reason if not."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or (
            cfg.attn.sliding_window > 0)
        if not sub_quadratic:
            return False, ("pure full-attention architecture; 500k decode "
                           "requires sub-quadratic attention")
    return True, ""


def takes_embeds(cfg: ModelConfig) -> bool:
    """Whether train and prefill batches carry embeddings, not ids."""
    return cfg.family in ("vlm", "audio")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The train / prefill batch: name -> (shape, dtype)."""
    B, S = shape.global_batch, shape.seq_len
    if takes_embeds(cfg):
        return {"embeds": ((B, S, cfg.d_model), cfg.torch_dtype),
                "targets": ((B, S), torch.int32),
                "mask": ((B, S), torch.int32)}
    return {"tokens": ((B, S), torch.int32), "mask": ((B, S), torch.int32)}


def decode_token_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    return {"tokens": ((shape.global_batch, 1), torch.int32)}


#: logical axes of every array a step's batch may carry
INPUT_LOGICAL = {"tokens": ("batch", "seq"), "mask": ("batch", "seq"),
                 "targets": ("batch", "seq"),
                 "embeds": ("batch", "seq", "act_embed")}


def batch_logical(cfg: ModelConfig, shape: InputShape) -> dict:
    """Logical axes of ``batch_specs``'s arrays (``sharding.rules``)."""
    return {k: INPUT_LOGICAL[k] for k in batch_specs(cfg, shape)}


def decode_token_logical(cfg: ModelConfig) -> dict:
    return {"tokens": INPUT_LOGICAL["tokens"]}
