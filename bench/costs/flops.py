"""Operations and bytes from shapes: the benchmark's own count, frozen
here so that a change to the program cannot change the yardstick.

Model FLOPs count the matrix products a forward pass needs (2 per
multiply-add): the q, k, v and output projections, q k^T and P V over
the (query, key) pairs the masks leave, the MLP, and the logits at the
positions whose logits are used.  Norms, RoPE, softmax and other
elementwise work are not counted.  Work a program does that no answer
needs (padded rows, logits nobody reads, masked keys) is not counted
either, so that removing it raises the share of the peak.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peak_flops(dtype: str) -> float:
    return PEAKS["flops_per_s"][dtype]


def attention_pairs(S: int, T: int, causal: bool, window: int,
                    offset: int = 0) -> int:
    """(query, key) pairs the masks leave for S queries at positions
    offset .. offset + S - 1 over keys 0 .. T - 1 (query i sees key j <=
    i when causal, and j > i - window with a window)."""
    row = np.arange(offset, offset + S, dtype=np.int64)
    lo = np.maximum(0, row - window + 1) if window > 0 else np.zeros_like(row)
    hi = np.minimum(row + 1, T) if causal else np.full_like(row, T)
    return int(np.maximum(0, hi - lo).sum())


def layer_token_flops(d: int, heads: int, kv_heads: int, head_dim: int,
                      ff: int, mlp_mats: int = 2) -> int:
    """FLOPs of one layer's projections and MLP for one token."""
    proj = 2 * d * head_dim * (heads + 2 * kv_heads) + 2 * heads * head_dim * d
    return proj + 2 * d * ff * mlp_mats


def forward_flops(shape: dict, batch: int, seq: int, *, causal: bool,
                  window: int = 0, offset: int = 0, keys: int | None = None,
                  logit_positions: int = 0) -> int:
    """FLOPs of a forward pass of ``batch`` sequences of ``seq`` tokens
    at positions ``offset`` on, attending over ``keys`` keys (default
    offset + seq), with logits at ``logit_positions`` positions of each
    sequence.  ``shape``: layers, d, heads, kv_heads, ff (head_dim d /
    heads), vocab."""
    L, d, H = shape["layers"], shape["d"], shape["heads"]
    hd = d // H
    T = offset + seq if keys is None else keys
    per_token = L * layer_token_flops(d, H, shape["kv_heads"], hd,
                                      shape["ff"])
    attn = L * 4 * H * hd * attention_pairs(seq, T, causal, window, offset)
    logits = 2 * d * shape["vocab"] * logit_positions
    return batch * (seq * per_token + attn + logits)


def flash_attention_cost(B: int, S: int, T: int, H: int, KV: int, hd: int,
                         causal: bool, window: int, elt: int):
    """(operations, bytes) of one flash-attention forward call: q k^T and
    P V over the pairs the masks leave (4 hd a head and pair); q, k, v
    read once and the output written once, ``elt`` bytes a value."""
    ops = 4 * B * H * hd * attention_pairs(S, T, causal, window)
    nbytes = elt * (2 * B * S * H * hd + 2 * B * T * KV * hd)
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate of ``dtype`` and bytes over the memory bandwidth."""
    return max(ops / peak_flops(dtype), nbytes / PEAKS["hbm_bytes_per_s"])
