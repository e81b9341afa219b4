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

The gradient: when grad mode is on and q, k, v or a gate needs one,
``mlstm_chunkwise`` runs as ``_MlstmChunkwise`` (a
``torch.autograd.Function``): on CUDA tensors the forward kernel, which
then also writes C and n at each chunk's start, and the backward kernel
``csrc/mlstm_scan_bwd.cu`` (``mlstm_chunkwise_bwd``; no Pallas
counterpart: the JAX package differentiates ``_mlstm_cell_chunkwise``
with XLA); on CPU tensors the plain version and
``mlstm_chunkwise_grad_plain``, autograd of it.  Training starts from a
state that needs no gradient and reads no final state, so the backward
takes no gradient into the initial state and none out of the final one:
an initial state that requires grad is refused before anything runs,
and a non-zero gradient arriving at the final state raises.
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


def _launch(q, k, v, i_pre, f_pre, state, keep_states):
    """The forward kernel: (h, {"C", "n", "m"}, and with ``keep_states``
    C and n at each chunk's start (Cst, nst), else None)."""
    B, S, H, dh = q.shape
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_chunkwise: head_dim {dh} must be a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}")
    L = pick_chunk(S, MAX_CHUNK)
    # the kernel stages rows with 16-byte copies: 16-byte aligned inputs
    args = [_aligned(t.detach().contiguous())
            for t in (q, k, v, i_pre, f_pre, state["C"], state["n"],
                      state["m"])]
    h = torch.empty_like(args[0])
    C1, n1, m1 = (torch.empty_like(t) for t in args[5:])
    lib = build.library()
    work = torch.empty(lib.size("tryage_mlstm_scan_workspace", B, S, H, L),
                       dtype=torch.float32, device=q.device)
    states = None
    if keep_states:
        states = (torch.empty(B, H, S // L, dh, dh, device=q.device),
                  torch.empty(B, H, S // L, dh, device=q.device))
    build.launch(
        "tryage_mlstm_scan", q.device, *(t.data_ptr() for t in args),
        h.data_ptr(), C1.data_ptr(), n1.data_ptr(), m1.data_ptr(),
        work.data_ptr(),
        *((None, None) if states is None else (t.data_ptr() for t in states)),
        B, S, H, dh, L, 1.0 / math.sqrt(dh))
    mlstm_chunkwise.launches += 1
    return h, {"C": C1, "n": n1, "m": m1}, states


def mlstm_chunkwise_grad_plain(q, k, v, i_pre, f_pre, state, dh,
                               chunk=MAX_CHUNK):
    """(dq, dk, dv, di, df) of ``mlstm_chunkwise_plain``'s h given its
    gradient ``dh``, by torch autograd, from a state that takes no
    gradient: the plain version the backward kernel is held against."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (q, k, v, i_pre, f_pre)]
        state = {n: t.detach() for n, t in state.items()}
        h, _ = mlstm_chunkwise_plain(*leaves, state, chunk)
        return torch.autograd.grad(h, leaves, dh)


def mlstm_chunkwise_bwd(q, k, v, i_pre, f_pre, state, h, dh, states):
    """(dq, dk, dv, di, df) of the scan's h from ``state``, given h (the
    forward's output) and its gradient ``dh``: ``csrc/mlstm_scan_bwd.cu``
    on CUDA tensors, from ``states`` = (Cst, nst), C and n at each
    chunk's start as the forward kernel writes them with ``keep_states``;
    ``mlstm_chunkwise_grad_plain`` on CPU ones, which needs neither h nor
    ``states``."""
    _check(q, k, v, i_pre, f_pre, state)
    if q.device.type == "cpu":
        return mlstm_chunkwise_grad_plain(q, k, v, i_pre, f_pre, state, dh)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise_bwd: no kernel for {q.device}")
    if h.shape != q.shape or dh.shape != q.shape or dh.dtype != q.dtype:
        raise ValueError(f"mlstm_chunkwise_bwd: h {tuple(h.shape)}, dh "
                         f"{tuple(dh.shape)} do not fit q {tuple(q.shape)}")
    B, S, H, d = q.shape
    L = pick_chunk(S, MAX_CHUNK)
    want = ((B, H, S // L, d, d), (B, H, S // L, d))
    if len(states) != 2 or any(tuple(t.shape) != w
                               for t, w in zip(states, want)):
        raise ValueError(f"mlstm_chunkwise_bwd: states "
                         f"{[tuple(t.shape) for t in states]}, want {want}")
    args = [_aligned(t.detach().contiguous())
            for t in (q, k, v, i_pre, f_pre, state["m"], *states, h, dh)]
    grads = [torch.empty_like(t) for t in args[:5]]
    lib = build.library()
    work = torch.empty(
        lib.size("tryage_mlstm_scan_bwd_workspace", B, S, H, d, L),
        dtype=torch.float32, device=q.device)
    build.launch(
        "tryage_mlstm_scan_bwd", q.device, *(t.data_ptr() for t in args),
        *(t.data_ptr() for t in grads), work.data_ptr(), B, S, H, d, L,
        1.0 / math.sqrt(d))
    mlstm_chunkwise_bwd.launches += 1
    return tuple(grads)


class _MlstmChunkwise(torch.autograd.Function):
    """The scan as one differentiable op from a state that takes no
    gradient: the forward kernel (writing the chunk-start states) and
    the backward kernel on CUDA tensors, the plain version and its
    autograd on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, C0, n0, m0):
        state = {"C": C0, "n": n0, "m": m0}
        if q.device.type == "cpu":    # the plain backward needs no states
            (h, out), states = mlstm_chunkwise_plain(q, k, v, i_pre, f_pre,
                                                     state), ()
        else:
            h, out, states = _launch(q, k, v, i_pre, f_pre, state, True)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, i_pre, f_pre, C0, n0, m0, h, *states)
        return h, out["C"], out["n"], out["m"]

    @staticmethod
    def backward(ctx, dh, dC1, dn1, dm1):
        for name, g in (("C", dC1), ("n", dn1), ("m", dm1)):
            if g is not None and bool((g != 0).any()):
                raise RuntimeError(
                    f"mlstm_chunkwise: a gradient reached the final state's "
                    f"{name!r}; the backward takes none out of the final "
                    f"state (training reads no state)")
        q, k, v, i_pre, f_pre, C0, n0, m0, h, *states = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        state = {"C": C0, "n": n0, "m": m0}
        grads = mlstm_chunkwise_bwd(q, k, v, i_pre, f_pre, state, h,
                                    dh.contiguous(), states)
        return (*grads, None, None, None)


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state):
    """The mLSTM over a sequence from ``state``: the kernel on CUDA
    tensors, ``mlstm_chunkwise_plain`` on CPU ones, each through
    ``_MlstmChunkwise`` when a gradient is needed.  Returns
    (h (B, S, H, dh), {"C", "n", "m"})."""
    _check(q, k, v, i_pre, f_pre, state)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlstm_chunkwise: no kernel for {q.device}")
    if torch.is_grad_enabled():
        if any(t.requires_grad for t in state.values()):
            raise RuntimeError(
                "mlstm_chunkwise: the initial state requires grad; the "
                "backward takes no gradient into the state (training starts "
                "from zeros): detach it")
        if any(t.requires_grad for t in (q, k, v, i_pre, f_pre)):
            h, C1, n1, m1 = _MlstmChunkwise.apply(
                q, k, v, i_pre, f_pre, state["C"], state["n"], state["m"])
            return h, {"C": C1, "n": n1, "m": m1}
    if q.device.type == "cpu":
        return mlstm_chunkwise_plain(q, k, v, i_pre, f_pre, state)
    h, out, _ = _launch(q, k, v, i_pre, f_pre, state, False)
    return h, out


mlstm_chunkwise.launches = 0
mlstm_chunkwise_bwd.launches = 0
