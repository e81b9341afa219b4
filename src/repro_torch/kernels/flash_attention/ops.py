"""Flash attention: the CUDA kernel's wrapper and its plain version.

``flash_attention`` takes the model layout of the JAX package's
``repro.kernels.flash_attention.ops.flash_attention``: q (B, S, H, hd),
k/v (B, T, KV, hd) with H % KV == 0, and returns (B, S, H, hd).  On a
CUDA tensor it launches ``csrc/flash_attention.cu`` (which replaces the
Pallas ``_attn_kernel`` of ``src/repro/kernels/flash_attention/kernel.py``
— see the source for the design and what bounds it); on a CPU tensor it
runs ``attention_plain``.  The kernel reads the model layout directly
and maps GQA heads by index, so neither the transpose to (BH, S, hd)
nor the K/V repeat of the JAX wrapper touches device memory.

``flash_attention_bwd`` is the gradient (``csrc/flash_attention_bwd.cu``,
which has no Pallas counterpart: the JAX package differentiates its XLA
attention; all five products in 3xTF32, one launch up to ``BLOCK_KEYS``
keys, two above); ``flash_attention`` runs forward and backward kernels
as one ``torch.autograd.Function`` when an input requires grad.

Bound on the H100: at the router's shapes the f32 operations (4*S*T*hd
per head, about 4 us for a router layer at B=32 on the CUDA cores); at
the zoo's bf16 prefill shapes the tensor cores' operations.  The kernel
runs both products on the TF32 tensor cores: 3xTF32 for f32 inputs,
which keeps f32 accuracy; for bf16 inputs (exact in TF32) one pass for
q k^T and two for P V (P stays f32).  The online softmax is in
registers and K/V tiles are staged in shared memory with cp.async, so
each block reads K and V once.  q, k, v are f32 or bf16 (all one type;
the output takes it), head_dim a multiple of 8 up to 256.  The backward
kernel takes f32 up to head_dim 128 and refuses the rest.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.3819763e38  # the Pallas kernel's mask fill
MAX_HEAD_DIM = 256
# the backward kernel (csrc/flash_attention_bwd.cu) is f32 up to hd 128;
# bf16 and wider heads are the zoo's training (ROADMAP.md)
MAX_HEAD_DIM_BWD = 128
DTYPES = (torch.float32, torch.bfloat16)
# keys of one block of the backward kernel (csrc/flash_attention_bwd.cu
# kBlockKeys): up to this many keys it runs as one launch; above, a
# first launch writes each row's sums to a (B, H, S, 2) workspace
BLOCK_KEYS = 128


def attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Full-softmax attention in f32, same layouts and masks as the
    kernel: the plain version it is held against."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float() / math.sqrt(hd), k.float())
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kj <= qi
    if window > 0:
        ok &= kj > qi - window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w, v.float()).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (B,S,H,hd), k/v (B,T,KV,hd);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")


def _check_backward(q):
    """Raise for what the backward kernel does not take (bf16, hd > 128),
    on any device, before anything runs."""
    hd = q.shape[-1]
    if q.dtype != torch.float32 or hd > MAX_HEAD_DIM_BWD:
        raise NotImplementedError(
            f"flash_attention backward: {q.dtype} at head_dim {hd}; the "
            f"backward kernel takes float32 up to head_dim "
            f"{MAX_HEAD_DIM_BWD} (training the zoo in bf16 and at wider "
            f"heads is ROADMAP.md queue 1, item 14)")


def _kernel_inputs(*tensors):
    # the kernels stage rows with 16-byte copies: contiguous, 16-byte
    # aligned inputs; those that already are go through untouched
    return [t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format)
            for t in tensors]


def _check_head_dim(hd):
    if hd > MAX_HEAD_DIM or hd % 8 or hd < 8:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}")


def _forward(q, k, v, causal, window, softcap, with_lse):
    """Launch the forward kernel: (o, lse or None)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    _check_head_dim(hd)
    q, k, v = _kernel_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if with_lse else None)
    build.launch(
        "tryage_flash_attention", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), 0 if lse is None else lse.data_ptr(),
        B, S, T, H, KV, hd, int(causal), int(window), float(softcap),
        1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16))
    flash_attention.launches += 1
    return o, lse


def attention_grad_plain(q, k, v, do, *, causal=True, window=0, softcap=0.0):
    """(dq, dk, dv) of ``attention_plain`` by torch autograd: the plain
    version the backward kernel is held against."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_plain(*leaves, causal=causal, window=window,
                              softcap=softcap)
        return torch.autograd.grad(out, leaves, do)


def flash_attention_bwd(q, k, v, lse, do, *, causal=True, window=0,
                        softcap=0.0):
    """(dq, dk, dv) of attention from the forward's log-sum-exp ``lse``
    (B, H, S) and the output gradient ``do``: ``csrc/flash_attention_bwd.cu``
    on CUDA tensors (one launch up to ``BLOCK_KEYS`` keys; above, a
    first launch for the row sums and dQ, then dK and dV), the plain
    version's autograd on CPU ones (``lse`` unused there).  f32 up to
    head_dim 128 on either device: anything else raises."""
    _check(q, k, v)
    _check_backward(q)
    if q.device.type == "cpu":
        return attention_grad_plain(q, k, v, do, causal=causal,
                                    window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (do.shape != q.shape or do.dtype != torch.float32
            or lse.shape != (B, H, S) or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    _check_head_dim(hd)
    q, k, v, do, lse = _kernel_inputs(q, k, v, do, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = (torch.empty(B, H, S, 2, dtype=torch.float32, device=q.device)
            if T > BLOCK_KEYS else None)
    build.launch(
        "tryage_flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        None if rows is None else rows.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, T, H, KV, hd, int(causal),
        int(window), float(softcap), 1.0 / math.sqrt(hd))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (keeping its log-sum-exp) and the backward
    kernel as one differentiable op on CUDA tensors (f32, head_dim up to
    128: it refuses the rest before the forward runs)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        _check_backward(q)
        o, lse = _forward(q, k, v, causal, window, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.masks = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        causal, window, softcap = ctx.masks
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                         window=window, softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Attention over (B, S, H, hd) queries and (B, T, KV, hd) keys and
    values; the kernel on CUDA tensors, the plain version on CPU ones.
    On CUDA tensors that need a gradient it runs as ``_FlashAttention``,
    whose backward is ``flash_attention_bwd``; otherwise the forward
    kernel alone, with no log-sum-exp written."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, with_lse=False)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
