"""Chunkwise mLSTM scan: the CUDA kernel's wrapper and its plain versions.

``mlstm_chunkwise`` takes the model layout of the JAX package's
``repro.kernels.mlstm_scan.ops.mlstm_chunkwise``: q/k/v (B, S, H, dh)
f32 (q not yet scaled), input and forget gate pre-activations i/f
(B, S, H) f32, and a state {"C": (B, H, dh, dh), "n": (B, H, dh),
"m": (B, H)}; it returns (h (B, S, H, dh), new state).  On CUDA tensors
it launches ``csrc/mlstm_scan.cu``, which replaces the Pallas
``_mlstm_kernel`` of ``src/repro/kernels/mlstm_scan/kernel.py`` (see the
source for the design and what bounds it; it takes head dims that are
multiples of 8 up to 1024); on CPU tensors it runs
``mlstm_chunkwise_plain``.

Beside it, the plain versions:

* ``mlstm_chunkwise_plain`` -- the port of
  ``repro.models.ssm._mlstm_cell_chunkwise``: the same closed form as
  the kernel, chunk by chunk in torch ops;
* ``mlstm_sequential`` -- the port of ``repro.models.ssm._mlstm_cell_seq``:
  the stabilised recurrence one step at a time.  ``models.ssm.mlstm_step``
  decodes through it, and the tests hold the other two against it.

The kernel's chunk length is ``pick_chunk(S, 64)``, the largest divisor
of S not above 64, as the JAX model path takes it, so any prompt length
runs.  ``mlstm_chunkwise_plain`` also takes other chunk lengths, as the
JAX reference does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.models.scan_utils import pick_chunk

MAX_CHUNK = 64        # the kernel's in-chunk tile is 64 x 64
MAX_HEAD_DIM = 1024   # a block's 32 columns of C fill its shared memory


def log_sigmoid(x):
    """log(sigmoid(x)) in the overflow-free form the kernel uses."""
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def mlstm_chunkwise_plain(q, k, v, i_pre, f_pre, state, chunk=MAX_CHUNK):
    """Chunkwise-parallel mLSTM in torch ops; same arguments and
    results as ``mlstm_chunkwise``."""
    B, T, H, dh = q.shape
    L = pick_chunk(T, chunk)
    qs = q * (1.0 / math.sqrt(dh))
    C, n, m = state["C"], state["n"], state["m"]
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    hs = []
    for c0 in range(0, T, L):
        sl = slice(c0, c0 + L)
        qc, kc, vc, ic, fc = qs[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], \
            f_pre[:, sl]
        F = torch.cumsum(log_sigmoid(fc), dim=1)                  # (B,L,H)
        g = torch.cummax(ic - F, dim=1).values
        m_t = F + torch.maximum(m[:, None], g)

        w_inter = torch.exp(F + m[:, None] - m_t)
        num = w_inter[..., None] * torch.einsum("blhk,bhkv->blhv", qc, C)
        den = w_inter * torch.einsum("blhk,bhk->blh", qc, n)

        logw = (F - m_t)[:, :, None] + (ic - F)[:, None]          # (B,Lq,Ls,H)
        W = torch.where(causal[None, :, :, None], logw,
                        torch.full_like(logw, -math.inf)).exp()
        WS = W * torch.einsum("blhk,bshk->blsh", qc, kc)
        num = num + torch.einsum("blsh,bshv->blhv", WS, vc)
        den = den + WS.sum(dim=2)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])

        m_last = m_t[:, -1]                                       # (B,H)
        kw = kc * torch.exp((F[:, -1:] - F) + ic - m_last[:, None])[..., None]
        decay = torch.exp(F[:, -1] + m - m_last)
        C = decay[..., None, None] * C + torch.einsum("bshk,bshv->bhkv",
                                                      kw, vc)
        n = decay[..., None] * n + kw.sum(dim=1)
        m = m_last
    return torch.cat(hs, dim=1), {"C": C, "n": n, "m": m}


def mlstm_sequential(q, k, v, i_pre, f_pre, state):
    """The stabilised mLSTM recurrence one time step at a time; same
    arguments and results as ``mlstm_chunkwise``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], i_pre[:, t], \
            f_pre[:, t]
        logf = log_sigmoid(ft)                                    # (B,H)
        m_new = torch.maximum(logf + m, it)
        f_act = torch.exp(logf + m - m_new)[..., None, None]
        i_act = torch.exp(it - m_new)[..., None, None]
        C = f_act * C + i_act * (kt[..., :, None] * vt[..., None, :])
        n = f_act[..., 0] * n + i_act[..., 0] * kt
        qs = qt * scale
        num = torch.einsum("bhkv,bhk->bhv", C, qs)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qs).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), {"C": C, "n": n, "m": m}


def _check(q, k, v, i_pre, f_pre, state):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_chunkwise: want q/k/v (B,S,H,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    want = {"i_pre": (i_pre, (B, S, H)), "f_pre": (f_pre, (B, S, H)),
            "C": (state["C"], (B, H, dh, dh)), "n": (state["n"], (B, H, dh)),
            "m": (state["m"], (B, H))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mlstm_chunkwise: {name} {tuple(t.shape)}, "
                             f"want {shape}")
    tensors = (q, k, v, i_pre, f_pre, state["C"], state["n"], state["m"])
    if any(t.device != q.device for t in tensors):
        raise ValueError("mlstm_chunkwise: inputs on different devices")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("mlstm_chunkwise: inputs and state must be float32")
    if S < 1:
        raise ValueError("mlstm_chunkwise: empty sequence")


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes
    (a view into a larger tensor)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state):
    """The mLSTM over a sequence from ``state``: the kernel on CUDA
    tensors, ``mlstm_chunkwise_plain`` on CPU ones.  Returns
    (h (B, S, H, dh), {"C", "n", "m"})."""
    _check(q, k, v, i_pre, f_pre, state)
    if q.device.type == "cpu":
        return mlstm_chunkwise_plain(q, k, v, i_pre, f_pre, state)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise: no kernel for {q.device}")
    build.refuse_grad("mlstm_chunkwise", q, k, v, i_pre, f_pre,
                      *state.values())
    B, S, H, dh = q.shape
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_chunkwise: head_dim {dh} must be a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}")
    L = pick_chunk(S, MAX_CHUNK)
    # the kernel stages rows with 16-byte copies: 16-byte aligned inputs
    args = [_aligned(t.contiguous()) for t in (q, k, v, i_pre, f_pre,
                                               state["C"], state["n"],
                                               state["m"])]
    h = torch.empty_like(args[0])
    C1, n1, m1 = (torch.empty_like(t) for t in args[5:])
    lib = build.library()
    work = torch.empty(lib.size("tryage_mlstm_scan_workspace", B, S, H, L),
                       dtype=torch.float32, device=q.device)
    build.launch(
        "tryage_mlstm_scan", q.device, *(t.data_ptr() for t in args),
        h.data_ptr(), C1.data_ptr(), n1.data_ptr(), m1.data_ptr(),
        work.data_ptr(), B, S, H, dh, L, 1.0 / math.sqrt(dh))
    mlstm_chunkwise.launches += 1
    return h, {"C": C1, "n": n1, "m": m1}


mlstm_chunkwise.launches = 0
