"""Recurrent cells of the xLSTM family: mLSTM and sLSTM
(``repro.models.ssm`` without Mamba, which comes with the rest of the
model zoo).

Each cell has the JAX package's three entry points:
  init_<cell>(gen, cfg, dtype)             -> nn.ParameterDict
  <cell>_full(p, x, cfg, state=None)       -> (y, final_state)   prefill
  <cell>_step(p, x1, state, cfg)           -> (y1, state)        decode

The dtype seams are the JAX package's: q/k/v come from products in the
model's type and are cast to f32; the mLSTM gates are
``main.float() @ w_if + b_if`` in f32; ``h * out_norm`` is f32 and cast
to the model's type before ``* silu(og)`` and ``out_proj``; the sLSTM's
``r_h`` and state are f32, with ``n`` initialised to ones.

``mlstm_full`` runs the recurrence through the ``mlstm_scan`` kernel
(``kernels.mlstm_scan.ops.mlstm_chunkwise``: the CUDA kernel on the
card, its chunkwise plain version on the CPU); ``mlstm_step`` through
the sequential plain cell, as the JAX package does.  The sLSTM
recurrence is a ``lax.scan`` there and a Python loop over time here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mlstm_scan.ops import (log_sigmoid, mlstm_chunkwise,
                                                mlstm_sequential)
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import trunc_normal


def _params(**tensors) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


# =================================================================== mLSTM

def _mlstm_dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H = s.num_heads
    return di, H, di // H


def init_mlstm(gen, cfg: ModelConfig, dtype=torch.float32):
    d = cfg.d_model
    di, H, dh = _mlstm_dims(cfg)
    s, si = 1 / math.sqrt(d), 1 / math.sqrt(di)
    return _params(
        in_proj=trunc_normal((d, 2 * di), s, gen, dtype),     # main + output gate
        wq=trunc_normal((di, H, dh), si, gen, dtype),
        wk=trunc_normal((di, H, dh), si, gen, dtype),
        wv=trunc_normal((di, H, dh), si, gen, dtype),
        w_if=trunc_normal((di, 2 * H), si, gen, torch.float32),
        b_if=torch.cat([torch.zeros(H), torch.full((H,), 3.0)]),
        out_norm=torch.ones(H, dh),
        out_proj=trunc_normal((di, d), si, gen, dtype))


def init_mlstm_state(batch: int, cfg: ModelConfig, device=None) -> dict:
    di, H, dh = _mlstm_dims(cfg)
    z = lambda *s: torch.zeros(*s, device=device)
    return {"C": z(batch, H, dh, dh), "n": z(batch, H, dh), "m": z(batch, H)}


def _mlstm_gates_qkv(p, x, cfg):
    u = x @ p["in_proj"]
    main, og = u.chunk(2, dim=-1)
    q = torch.einsum("bti,ihk->bthk", main, p["wq"])
    k = torch.einsum("bti,ihk->bthk", main, p["wk"])
    v = torch.einsum("bti,ihk->bthk", main, p["wv"])
    gif = main.float() @ p["w_if"] + p["b_if"]
    i_pre, f_pre = gif.chunk(2, dim=-1)                       # (B,T,H)
    return q, k, v, i_pre, f_pre, og


def _mlstm_out(p, h, og, x, cfg):
    B, T = h.shape[:2]
    di = _mlstm_dims(cfg)[0]
    h = (h * p["out_norm"]).reshape(B, T, di).to(x.dtype) * F.silu(og)
    return h @ p["out_proj"]


def mlstm_full(p, x, cfg: ModelConfig, state=None):
    """x (B, T, d) -> (y (B, T, d), state); the recurrence through the
    ``mlstm_scan`` kernel wrapper, chunk ``pick_chunk(T, 64)``."""
    if state is None:
        state = init_mlstm_state(x.shape[0], cfg, x.device)
    q, k, v, i_pre, f_pre, og = _mlstm_gates_qkv(p, x, cfg)
    h, state = mlstm_chunkwise(q.float(), k.float(), v.float(), i_pre, f_pre,
                               state)
    return _mlstm_out(p, h, og, x, cfg), state


def mlstm_step(p, x1, state, cfg: ModelConfig):
    """x1 (B, 1, d) -> (y1, state), through the sequential cell."""
    q, k, v, i_pre, f_pre, og = _mlstm_gates_qkv(p, x1, cfg)
    h, state = mlstm_sequential(q.float(), k.float(), v.float(), i_pre,
                                f_pre, state)
    return _mlstm_out(p, h, og, x1, cfg), state


# =================================================================== sLSTM

def _slstm_dims(cfg: ModelConfig):
    H = cfg.ssm.num_heads
    return H, cfg.d_model // H


def init_slstm(gen, cfg: ModelConfig, dtype=torch.float32):
    d = cfg.d_model
    H, dh = _slstm_dims(cfg)
    return _params(
        w_x=trunc_normal((d, 4 * d), 1 / math.sqrt(d), gen, dtype),  # z i f o
        r_h=trunc_normal((4, H, dh, dh), 1 / math.sqrt(dh), gen,
                         torch.float32),
        b=torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0),
                     torch.zeros(d)]),
        out_proj=trunc_normal((d, d), 1 / math.sqrt(d), gen, dtype))


def init_slstm_state(batch: int, cfg: ModelConfig, device=None) -> dict:
    d = cfg.d_model
    z = torch.zeros(batch, d, device=device)
    return {"h": z, "c": z, "n": torch.ones(batch, d, device=device),
            "m": z}


def _slstm_cell_seq(p, wx, st, cfg):
    """wx: (B, T, 4d) input projections.  Returns (hs (B, T, d) f32,
    state)."""
    H, dh = _slstm_dims(cfg)
    B, T, _ = wx.shape
    d = H * dh
    h, c, n, m = st["h"], st["c"], st["n"], st["m"]
    # xt + b before the recurrent term, as the JAX step adds them
    xb = wx.float() + p["b"]
    hs = []
    for t in range(T):
        # (B, 4, H, dh) flattened is the JAX concat of the 4 gates' rec
        rec = torch.einsum("ghkl,bhk->bghl", p["r_h"],
                           h.reshape(B, H, dh)).reshape(B, 4 * d)
        z_pre, i_pre, f_pre, o_pre = (xb[:, t] + rec).chunk(4, dim=-1)
        logf = log_sigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        i_act = torch.exp(i_pre - m_new)
        f_act = torch.exp(logf + m - m_new)
        c = f_act * c + i_act * torch.tanh(z_pre)
        n = f_act * n + i_act
        h = torch.sigmoid(o_pre) * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"h": h, "c": c, "n": n, "m": m}


def slstm_full(p, x, cfg: ModelConfig, state=None):
    if state is None:
        state = init_slstm_state(x.shape[0], cfg, x.device)
    hs, state = _slstm_cell_seq(p, x @ p["w_x"], state, cfg)
    return hs.to(x.dtype) @ p["out_proj"], state


def slstm_step(p, x1, state, cfg: ModelConfig):
    return slstm_full(p, x1, cfg, state)
