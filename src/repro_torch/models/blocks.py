"""Per-layer blocks (``repro.models.blocks``): pre-norm mixer of kind
``"attn"``, ``"mamba"``, ``"mlstm"`` or ``"slstm"`` with its residual,
then, when ``d_ff > 0``, a pre-norm MLP with its residual: dense, or
for a layer that ``moe_pattern`` marks, the MoE MLP (``models/moe.py``),
whose load-balance term each block returns.  Attention prefill builds
the layer's KV cache, decode steps against it; a recurrent layer's
prefill returns its state and decode steps it."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, init_mlp,
                                       init_norm, mlp_logical, norm_logical)
from repro_torch.models.moe import init_moe, moe_logical
from repro_torch.sharding.context import shard_act

KINDS = ("attn", "mamba", "mlstm", "slstm")
MODES = ("train", "encode", "prefill", "decode")


class Block(nn.ModuleDict):
    """Parameters keyed as the JAX package's block tree: ``norm1``,
    ``mix`` (the mixer's parameters), and with ``d_ff > 0`` ``norm2``
    and ``mlp`` (a ``moe.MoE`` when ``use_moe``)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, kind: str,
                 layer_idx: int, use_moe: bool = False):
        if kind not in KINDS:
            raise ValueError(f"{cfg.name}: block kind {kind!r} not in "
                             f"{KINDS}")
        dtype = cfg.torch_dtype
        init_mix = {"attn": attn_lib.init_attention,
                    "mamba": ssm_lib.init_mamba,
                    "mlstm": ssm_lib.init_mlstm,
                    "slstm": ssm_lib.init_slstm}[kind]
        mods = {"norm1": init_norm(cfg.d_model, cfg.norm_kind),
                "mix": init_mix(gen, cfg, dtype)}
        if cfg.d_ff > 0:
            mods["norm2"] = init_norm(cfg.d_model, cfg.norm_kind)
            mods["mlp"] = (init_moe(gen, cfg, dtype) if use_moe else
                           init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                    cfg.act))
        super().__init__(mods)
        self.cfg = cfg
        self.kind = kind
        self.layer_idx = layer_idx
        self.use_moe = use_moe

    def forward(self, x, *, mode, positions, state=None, index=None,
                cache_capacity=None):
        return apply_block(self, x, self.cfg, self.kind, self.use_moe,
                           mode=mode, layer_idx=self.layer_idx,
                           positions=positions, state=state, index=index,
                           cache_capacity=cache_capacity)


def block_logical(cfg: ModelConfig, kind: str, use_moe: bool = False) -> dict:
    """Logical axes of a ``Block``'s leaves, keyed as its parameters."""
    mix = (attn_lib.attention_logical(cfg) if kind == "attn" else
           {"mamba": ssm_lib.MAMBA_LOGICAL, "mlstm": ssm_lib.MLSTM_LOGICAL,
            "slstm": ssm_lib.SLSTM_LOGICAL}[kind])
    out = {"norm1": norm_logical(cfg.norm_kind), "mix": dict(mix)}
    if cfg.d_ff > 0:
        out["norm2"] = norm_logical(cfg.norm_kind)
        out["mlp"] = moe_logical(cfg) if use_moe else mlp_logical(cfg.act)
    return out


def block_state_logical(kind: str) -> dict:
    """Logical axes of ``init_block_state``'s leaves."""
    return dict({"attn": attn_lib.KV_CACHE_LOGICAL,
                 "mamba": ssm_lib.MAMBA_STATE_LOGICAL,
                 "mlstm": ssm_lib.MLSTM_STATE_LOGICAL,
                 "slstm": ssm_lib.SLSTM_STATE_LOGICAL}[kind])


def init_block_state(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int = 0, device=None, layer_idx: int = 0):
    """Decode-time state of one layer: the recurrent state, or a zero KV
    cache of ``cache_len`` slots, ``min(cache_len, window)`` for a
    sliding-window layer (its ring)."""
    if kind == "attn":
        window = attn_lib.layer_window(cfg, layer_idx)
        if window > 0:
            cache_len = min(cache_len, window)
        return attn_lib.init_kv_cache(batch, cache_len, cfg, cfg.torch_dtype,
                                      device)
    if kind == "mamba":
        return ssm_lib.init_mamba_state(batch, cfg, cfg.torch_dtype, device)
    if kind == "mlstm":
        return ssm_lib.init_mlstm_state(batch, cfg, device)
    if kind == "slstm":
        return ssm_lib.init_slstm_state(batch, cfg, device)
    raise ValueError(kind)


def apply_block(p, x, cfg: ModelConfig, kind: str, use_moe: bool = False, *,
                mode: str, layer_idx: int, positions, state=None, index=None,
                cache_capacity=None):
    """Returns (x, new_state, aux): the state is None in ``train`` and
    ``encode`` modes; aux is the MoE layer's load-balance term (an f32
    scalar), 0.0 for a layer without MoE.  Prefill starts every
    recurrent layer from zeros and builds every attention layer's cache
    (``cache_capacity`` slots for full attention), as the JAX package
    does; decode steps from ``state`` with the token at absolute
    position ``index``.  An MoE layer's ``p["mlp"]`` is a ``moe.MoE``,
    called as a module (so its forward hooks see each call's input).

    ``layer_idx`` is the layer's index in the model.  The JAX package
    passes a scanned unit's blocks their index within the unit and the
    remainder layers ``U * unit + j``; under every window pattern of
    ``layer_window`` the two give the same windows whenever the unit's
    length is a multiple of ``global_every`` (``tests/test_torch_zoo.py``
    holds gemma3's 34 layers to it)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    h = apply_norm(p["norm1"], x, cfg.norm_eps, cfg.norm_kind)
    decode = mode == "decode"
    new_state = None
    if kind == "attn":
        window = attn_lib.layer_window(cfg, layer_idx)
        if decode:
            y, new_state = attn_lib.attend_decode(p["mix"], h, state, index,
                                                  cfg, positions, window)
        else:
            y, (k, v) = attn_lib.attend_full(p["mix"], h, cfg, positions,
                                             window)
            if mode == "prefill":
                new_state = attn_lib.prefill_cache_from_kv(
                    k, v, window, cfg.torch_dtype, capacity=cache_capacity)
    elif kind == "mamba":
        y, new_state = (ssm_lib.mamba_step(p["mix"], h, state, cfg) if decode
                        else ssm_lib.mamba_full(p["mix"], h, cfg))
    elif kind == "mlstm":
        y, new_state = (ssm_lib.mlstm_step(p["mix"], h, state, cfg) if decode
                        else ssm_lib.mlstm_full(p["mix"], h, cfg))
    elif kind == "slstm":
        y, new_state = (ssm_lib.slstm_step(p["mix"], h, state, cfg) if decode
                        else ssm_lib.slstm_full(p["mix"], h, cfg))
    else:
        raise ValueError(kind)
    x = shard_act(x + y.to(x.dtype), ("batch", "seq", "act_embed"))
    aux = 0.0
    if "mlp" in p:
        h2 = apply_norm(p["norm2"], x, cfg.norm_eps, cfg.norm_kind)
        if use_moe:
            y2, aux = p["mlp"](h2)
        else:
            y2 = apply_mlp(p["mlp"], h2, cfg.act)
        x = shard_act(x + y2.to(x.dtype), ("batch", "seq", "act_embed"))
    if mode in ("train", "encode"):
        new_state = None
    return x, new_state, aux
