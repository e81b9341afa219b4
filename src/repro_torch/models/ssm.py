"""Recurrent cells: Mamba (selective SSM), mLSTM and sLSTM
(``repro.models.ssm``).

Each cell has the JAX package's three entry points:
  init_<cell>(gen, cfg, dtype)             -> nn.ParameterDict
  <cell>_full(p, x, cfg, state=None)       -> (y, final_state)   prefill
  <cell>_step(p, x1, state, cfg)           -> (y1, state)        decode

Mamba is plain PyTorch, as the reference's is XLA: ``mamba_full``
runs chunks of ``pick_chunk(T, 256)`` steps one after another, carrying
the state (f32 ``h`` (B, di, ds) and the causal convolution's last
``d_conv - 1`` inputs ``conv`` in the activations' type); within a chunk
the linear recurrence h_t = dA_t h_{t-1} + dBx_t is a scan of log2(L)
doubling steps over (B, L, di, ds) f32 tensors (the reference's
``associative_scan`` with the same combine), with no loop over time.
Under autograd each chunk's scan runs in a checkpoint: its (B, L, di,
ds) intermediates, some twenty a chunk, are computed again in the
backward rather than kept (a remat'd jamba unit of 7 Mamba layers at
2,048 tokens would keep over 70 GB of them a card on a (2, 2) mesh).
``mamba_step`` is the recurrence for one token.

The mLSTM/sLSTM dtype seams are the JAX package's: q/k/v come from
products in the model's type and are cast to f32; the mLSTM gates are
``main.float() @ w_if + b_if`` in f32; ``h * out_norm`` is f32 and cast
to the model's type before ``* silu(og)`` and ``out_proj``; the sLSTM's
``r_h`` and state are f32, with ``n`` initialised to ones.

``mlstm_full`` runs the recurrence through the ``mlstm_scan`` kernel
(``kernels.mlstm_scan.ops.mlstm_chunkwise``: the CUDA kernel on the
card, its chunkwise plain version on the CPU); ``mlstm_step`` through
the sequential plain cell, as the JAX package does.  The sLSTM
recurrence keeps the reference's structure: ``chunked_scan`` over chunks
of ``pick_chunk(T, 128)`` steps, each chunk a loop over time (a
``lax.scan`` there, a Python loop here) checkpointed under autograd, so
a backward keeps the chunk-boundary states and one chunk's
intermediates; the recurrent weights are laid out for the product once
a call.  On ``meta`` tensors (the dry run) both loops are counted by
trip count (``launch.op_costs.counted_loop``).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.mlstm_scan.ops import (log_sigmoid, mlstm_chunkwise,
                                                mlstm_sequential)
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import head_proj, trunc_normal
from repro_torch.launch import op_costs
from repro_torch.models.scan_utils import chunked_scan, pick_chunk
from repro_torch.sharding import local
from repro_torch.sharding.context import (distribute, is_dtensor,
                                          recompute_context, shard_act,
                                          shard_zeros)


def _params(**tensors) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


# =================================================================== mamba

def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, s.d_state, s.d_conv, dt_rank


def init_mamba(gen, cfg: ModelConfig, dtype=torch.float32):
    d = cfg.d_model
    di, ds, dc, dtr = _mamba_dims(cfg)
    in_proj = trunc_normal((d, 2 * di), 1 / math.sqrt(d), gen, dtype)
    conv_w = trunc_normal((dc, di), 1 / math.sqrt(dc), gen, dtype)
    x_proj = trunc_normal((di, dtr + 2 * ds), 1 / math.sqrt(di), gen, dtype)
    dt_w = trunc_normal((dtr, di), 1 / math.sqrt(dtr), gen, dtype)
    # dt's bias: softplus^-1 of a step drawn log-uniform in [1e-3, 1e-1]
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(di, generator=gen) * (hi - lo) + lo
    return _params(
        in_proj=in_proj, conv_w=conv_w, conv_b=torch.zeros(di, dtype=dtype),
        x_proj=x_proj, dt_w=dt_w,
        dt_b=torch.log(torch.expm1(torch.exp(u))),
        A_log=torch.log(torch.arange(1, ds + 1, dtype=torch.float32)
                        ).expand(di, ds).contiguous(),
        D=torch.ones(di),
        out_proj=trunc_normal((di, d), 1 / math.sqrt(di), gen, dtype))


MAMBA_LOGICAL = {"in_proj": ("embed", "inner"), "conv_w": ("conv", "inner"),
                 "conv_b": ("inner",), "x_proj": ("inner", "state"),
                 "dt_w": ("state", "inner"), "dt_b": ("inner",),
                 "A_log": ("inner", "state"), "D": ("inner",),
                 "out_proj": ("inner", "embed")}
MAMBA_STATE_LOGICAL = {"h": ("batch", "inner", "state"),
                       "conv": ("batch", "conv", "inner")}


def init_mamba_state(batch: int, cfg: ModelConfig, dtype=torch.float32,
                     device=None) -> dict:
    di, ds, dc, _ = _mamba_dims(cfg)
    return {"h": torch.zeros(batch, di, ds, device=device),
            "conv": torch.zeros(batch, dc - 1, di, dtype=dtype,
                                device=device)}


def _scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 from h = 0,
    and the running product of a: (a_cum, b_cum), by log2(T) doubling
    steps of the reference's combine (l, r) -> (a_l a_r, a_r b_l + b_r)."""
    T, s = a.shape[1], 1
    while s < T:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], 1)
        a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], 1)
        s *= 2
    return a, b


def _mamba_inner(p, xs_conv, dt, Bm, Cm, h0):
    """Selective scan over one chunk.  xs_conv (B, T, di) f32 post-conv
    activations; dt (B, T, di); Bm/Cm (B, T, ds); h0 (B, di, ds).
    Returns (y (B, T, di), hT)."""
    A = -torch.exp(p["A_log"])                                # (di, ds)
    dA = torch.exp(dt[..., None] * A)                         # (B,T,di,ds)
    dBx = (dt * xs_conv)[..., None] * Bm[:, :, None, :]       # (B,T,di,ds)
    a_cum, b_cum = _scan(dA, dBx)
    h = a_cum * h0[:, None] + b_cum
    y = torch.einsum("btds,bts->btd", h, Cm) + p["D"] * xs_conv
    return y, h[:, -1]


def _mamba_preproj(p, x):
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    return (shard_act(xs, ("batch", "seq", "inner")),
            shard_act(z, ("batch", "seq", "inner")))


def _mamba_postconv(p, xc, cfg):
    """xc: conv output (B, T, di).  Returns dt, Bm, Cm (f32)."""
    _, ds, _, dtr = _mamba_dims(cfg)
    # on a mesh the sums over the inner dim are reduced here, before the
    # dt projection re-shards it
    dbc = shard_act((xc @ p["x_proj"]).float(), ("batch", "seq", None))
    dt_in, Bm, Cm = dbc.split([dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_in @ p["dt_w"].float() + p["dt_b"])
    return dt, Bm, Cm


def _causal_conv(p, xs, prev, dc):
    """xs: (B, T, di); prev: (B, dc-1, di) left context.  Returns (out,
    new_prev): the depthwise causal convolution then silu, and the
    last dc-1 inputs."""
    ext = torch.cat([prev.to(xs.dtype), xs], 1)               # (B,T+dc-1,di)
    T = xs.shape[1]
    out = sum(ext[:, i:i + T] * p["conv_w"][i] for i in range(dc))
    out = F.silu(out + p["conv_b"])
    new_prev = ext[:, -(dc - 1):] if dc > 1 else prev
    return out, new_prev


def mamba_full(p, x, cfg: ModelConfig, state=None, chunk=256):
    """x (B, T, d) -> (y (B, T, d), state), chunk by chunk."""
    B, T, _ = x.shape
    dc = _mamba_dims(cfg)[2]
    if state is None:
        state = init_mamba_state(B, cfg, x.dtype, x.device)
    xs, z = _mamba_preproj(p, x)
    ck = pick_chunk(T, chunk)
    h, conv = state["h"], state["conv"]
    ys = []
    for t in range(0, T, ck):
        xc, conv = _causal_conv(p, xs[:, t:t + ck], conv, dc)
        dt, Bm, Cm = _mamba_postconv(p, xc, cfg)
        if torch.is_grad_enabled():
            y, h = checkpoint(_mamba_inner, p, xc.float(), dt, Bm, Cm, h,
                              use_reentrant=False,
                              context_fn=recompute_context)
        else:
            y, h = _mamba_inner(p, xc.float(), dt, Bm, Cm, h)
        ys.append(y)
    out = torch.cat(ys, 1).to(x.dtype) * F.silu(z)
    return out @ p["out_proj"], {"h": h, "conv": conv}


def mamba_step(p, x1, state, cfg: ModelConfig):
    """x1: (B, 1, d) -> (y1, state)."""
    dc = _mamba_dims(cfg)[2]
    xs, z = _mamba_preproj(p, x1)
    xc, new_conv = _causal_conv(p, xs, state["conv"], dc)
    dt, Bm, Cm = _mamba_postconv(p, xc, cfg)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[:, 0, :, None] * A)                     # (B,di,ds)
    xc0 = xc[:, 0].float()
    dBx = (dt[:, 0] * xc0)[..., None] * Bm[:, 0, None, :]
    h = dA * state["h"] + dBx
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0]) + p["D"] * xc0
    out = y[:, None].to(x1.dtype) * F.silu(z)
    return out @ p["out_proj"], {"h": h, "conv": new_conv}


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


MLSTM_LOGICAL = {"in_proj": ("embed", "inner"),
                 "wq": ("inner", "heads", "head_dim"),
                 "wk": ("inner", "heads", "head_dim"),
                 "wv": ("inner", "heads", "head_dim"),
                 "w_if": ("inner", "heads"), "b_if": ("heads",),
                 "out_norm": ("heads", "head_dim"),
                 "out_proj": ("inner", "embed")}
MLSTM_STATE_LOGICAL = {"C": ("batch", "heads", "head_dim", "head_dim"),
                       "n": ("batch", "heads", "head_dim"),
                       "m": ("batch", "heads")}


def init_mlstm_state(batch: int, cfg: ModelConfig, device=None) -> dict:
    di, H, dh = _mlstm_dims(cfg)
    z = lambda *s: torch.zeros(*s, device=device)
    return {"C": z(batch, H, dh, dh), "n": z(batch, H, dh), "m": z(batch, H)}


def _mlstm_gates_qkv(p, x, cfg):
    u = x @ p["in_proj"]
    main, og = u.chunk(2, dim=-1)
    q, k, v = (head_proj(main, p[w], "heads") for w in ("wq", "wk", "wv"))
    gif = main.float() @ p["w_if"] + p["b_if"]
    i_pre, f_pre = gif.chunk(2, dim=-1)                       # (B,T,H)
    return q, k, v, i_pre, f_pre, og


def _mlstm_out(p, h, og, x, cfg):
    B, T = h.shape[:2]
    di, H, _ = _mlstm_dims(cfg)
    # on a mesh the merged (heads x head_dim) dim is pinned by its heads,
    # so that its gradient unflattens
    h = shard_act((h * p["out_norm"]).reshape(B, T, di),
                  ("batch", "seq", "heads"), dim_sizes=(B, T, H))
    h = h.to(x.dtype) * F.silu(og)
    return h @ p["out_proj"]


def mlstm_full(p, x, cfg: ModelConfig, state=None):
    """x (B, T, d) -> (y (B, T, d), state); the recurrence through the
    ``mlstm_scan`` kernel wrapper, chunk ``pick_chunk(T, 64)``; without a
    ``state`` it starts from zeros and says so to the backward, which
    then skips the products that read the initial state.  On a mesh
    each device runs the wrapper on its own (batch, head) blocks
    (``sharding.local.scan_on_shards``)."""
    zero_state = state is None
    if zero_state:
        di, H, dh = _mlstm_dims(cfg)
        B = x.shape[0]
        shapes = {"C": (B, H, dh, dh), "n": (B, H, dh), "m": (B, H)}
        # on a mesh each device allocates its own shard alone
        state = {k: shard_zeros(s, MLSTM_STATE_LOGICAL[k], device=x.device)
                 for k, s in shapes.items()}
    q, k, v, i_pre, f_pre, og = _mlstm_gates_qkv(p, x, cfg)
    args = (q.float(), k.float(), v.float(), i_pre, f_pre, state)
    if is_dtensor(q):
        h, state = local.scan_on_shards(functools.partial(
            mlstm_chunkwise, zero_state=zero_state), *args)
    else:
        h, state = mlstm_chunkwise(*args, zero_state=zero_state)
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


SLSTM_LOGICAL = {"w_x": ("embed", "inner"),
                 "r_h": ("conv", "heads", "head_dim", "head_dim"),
                 "b": ("inner",), "out_proj": ("embed", "embed")}
SLSTM_STATE_LOGICAL = {k: ("batch", "inner") for k in ("h", "c", "n", "m")}


def init_slstm_state(batch: int, cfg: ModelConfig, device=None) -> dict:
    d = cfg.d_model
    z = torch.zeros(batch, d, device=device)
    return {"h": z, "c": z, "n": torch.ones(batch, d, device=device),
            "m": z}


def _recurrent(r_h, cfg):
    """``r_h`` (4, H, dh, dh) laid out once for the time loop's product:
    (H, dh, 4 dh), the operand ``einsum("ghkl,bhk->...")`` lays out for
    its ``bmm`` (it would copy it afresh every step)."""
    H, dh = _slstm_dims(cfg)
    return r_h.permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)


def _slstm_cell_seq(R, b, wx, st, cfg):
    """wx: (B, T, 4d) input projections; R: ``_recurrent(r_h)``.
    Returns (hs (B, T, d) f32, state): a loop over time
    (``op_costs.counted_loop``)."""
    H, dh = _slstm_dims(cfg)
    B, T, _ = wx.shape
    d = H * dh
    # xt + b before the recurrent term, as the JAX step adds them
    xb = wx.float() + b

    def step(carry, xt):
        h, c, n, m = carry
        # (H, B, 4 dh): the JAX einsum's rec of each head; as (B, 4, H,
        # dh) its concat of the 4 gates
        rec = torch.bmm(h.reshape(B, H, dh).transpose(0, 1), R)
        pre = (xt.view(B, 4, H, dh)
               + rec.view(H, B, 4, dh).permute(1, 2, 0, 3))
        z_pre, i_pre, f_pre, o_pre = pre.reshape(B, 4 * d).chunk(4, dim=-1)
        logf = log_sigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        i_act = torch.exp(i_pre - m_new)
        f_act = torch.exp(logf + m - m_new)
        c = f_act * c + i_act * torch.tanh(z_pre)
        n = f_act * n + i_act
        h = torch.sigmoid(o_pre) * (c / torch.clamp(n, min=1e-6))
        return (h, c, n, m_new), h

    (h, c, n, m), hs = op_costs.counted_loop(
        step, (st["h"], st["c"], st["n"], st["m"]), xb.unbind(1),
        "slstm.steps")
    return torch.stack(hs, dim=1), {"h": h, "c": c, "n": n, "m": m}


def _slstm_scan(r_h, b, wx, st, cfg, chunk):
    """The recurrence over wx (B, T, 4d) from ``st`` as the reference
    runs it: ``chunked_scan`` over chunks of ``pick_chunk(T, chunk)``
    steps, each chunk's loop checkpointed under autograd, the recurrent
    weights laid out once.  (hs (B, T, d) f32, state)."""
    R = _recurrent(r_h, cfg)

    def step(state, wx_chunk):
        hs, state = _slstm_cell_seq(R, b, wx_chunk, state, cfg)
        return state, hs

    state, hs = chunked_scan(step, st, wx, seq_axis=1,
                             chunk=pick_chunk(wx.shape[1], chunk),
                             name="slstm.chunks")
    return hs, state


def _slstm_per_step(r_h, b, wx, st, cfg, chunk=None):
    """``_slstm_scan`` as one loop over all T steps, the recurrent
    product as the reference's einsum every step (``r_h`` laid out
    afresh and saved each step), nothing checkpointed: the form the
    chunked scan replaced.  The tests, ``chip_smoke.py`` and
    ``scripts/dryrun_slstm_forms.py`` hold ``_slstm_scan`` against it
    (bits, memory, time); nothing on a step's path calls it."""
    H, dh = _slstm_dims(cfg)
    B, T, _ = wx.shape
    d = H * dh
    xb = wx.float() + b

    def step(carry, xt):
        h, c, n, m = carry
        rec = torch.einsum("ghkl,bhk->bghl", r_h,
                           h.reshape(B, H, dh)).reshape(B, 4 * d)
        z_pre, i_pre, f_pre, o_pre = (xt + rec).chunk(4, dim=-1)
        logf = log_sigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        i_act = torch.exp(i_pre - m_new)
        f_act = torch.exp(logf + m - m_new)
        c = f_act * c + i_act * torch.tanh(z_pre)
        n = f_act * n + i_act
        h = torch.sigmoid(o_pre) * (c / torch.clamp(n, min=1e-6))
        return (h, c, n, m_new), h

    (h, c, n, m), hs = op_costs.counted_loop(
        step, (st["h"], st["c"], st["n"], st["m"]), xb.unbind(1),
        "slstm.steps")
    return torch.stack(hs, dim=1), {"h": h, "c": c, "n": n, "m": m}


def _sharded_slstm(p, wx, st, cfg, chunk):
    """``_slstm_scan`` per device on its batch block (each row's
    recurrence is independent; DTensor would dispatch every step's ops
    through its sharding propagation); the recurrent weights and bias
    are gathered, their gradients partial sums over the batch's
    blocks."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = wx.device_mesh
    bw = local.keep_shards(wx, (0,))
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if q.is_shard() else Replicate() for q in bw)
    keys = ("h", "c", "n", "m")
    args = ([local.laid_out(wx, bw)]
            + [local.laid_out(p[k], rep) for k in ("r_h", "b")]
            # a fresh state is plain: each rank keeps its block
            + [local.laid_out(st[k], bw) if is_dtensor(st[k])
               else distribute(st[k], mesh, bw) for k in keys])

    def run(wl, rl, bl, *state):
        hs, out = _slstm_scan(rl, bl, wl, dict(zip(keys, state)), cfg, chunk)
        return (hs, *(out[k] for k in keys))

    hs, *state = local_map(
        run, out_placements=(bw,) * 5,
        in_placements=(bw, rep, rep) + (bw,) * 4,
        in_grad_placements=(bw, part, part) + (bw,) * 4,
        device_mesh=mesh)(*args)
    return hs, dict(zip(keys, state))


def slstm_full(p, x, cfg: ModelConfig, state=None, chunk=128):
    """x (B, T, d) -> (y (B, T, d), state) through ``_slstm_scan``
    (chunks of ``pick_chunk(T, chunk)`` steps, as the reference's); on a
    mesh per device (``_sharded_slstm``)."""
    if state is None:
        state = init_slstm_state(x.shape[0], cfg, x.device)
    wx = x @ p["w_x"]
    if is_dtensor(wx):
        hs, state = _sharded_slstm(p, wx, state, cfg, chunk)
    else:
        hs, state = _slstm_scan(p["r_h"], p["b"], wx, state, cfg, chunk)
    return hs.to(x.dtype) @ p["out_proj"], state


def slstm_step(p, x1, state, cfg: ModelConfig):
    return slstm_full(p, x1, cfg, state)
