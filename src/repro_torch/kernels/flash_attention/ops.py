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

Bound on the H100: at the main path's shapes the f32 operations (4*S*T*hd
per head, about 4 us for a router layer at B=32 on the CUDA cores); the
kernel runs both products on the tensor cores in 3xTF32, which keeps
f32 accuracy, with the online softmax in registers and K/V tiles
staged in shared memory with cp.async, so each block reads K and V
once.  head_dim must be a multiple of 8 up to 128.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.3819763e38  # the Pallas kernel's mask fill
MAX_HEAD_DIM = 128


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
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError("flash_attention: q, k, v must be float32")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Attention over (B, S, H, hd) queries and (B, T, KV, hd) keys and
    values; the kernel on CUDA tensors, the plain version on CPU ones."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    build.refuse_grad("flash_attention", q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}")
    # K and V are staged with 16-byte copies: 16-byte aligned inputs
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
               for t in (q.contiguous(), k.contiguous(), v.contiguous()))
    o = torch.empty_like(q)
    build.launch(
        "tryage_flash_attention", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), B, S, T, H, KV, hd, int(causal),
        int(window), float(softcap), 1.0 / math.sqrt(hd))
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
