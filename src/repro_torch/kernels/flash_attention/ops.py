"""Flash attention: the CUDA kernel's wrapper and its plain version.

``flash_attention`` takes the model layout of the JAX package's
``repro.kernels.flash_attention.ops.flash_attention``: q (B, S, H, hd),
k/v (B, T, KV, hd) with H % KV == 0, and returns (B, S, H, hd).  On a
CUDA tensor it launches ``csrc/flash_attention.cu`` (which replaces the
Pallas ``_attn_kernel`` of ``src/repro/kernels/flash_attention/kernel.py``
— see the source for the design and what bounds it); on a CPU tensor it
runs ``attention_plain``.  The kernel reads the model layout directly
and maps GQA heads by index, so neither the transpose to (BH, S, hd)
nor the K/V repeat of the JAX wrapper touches device memory.  On meta
tensors (the dry run) it gives the outputs' shapes; inside a counted
region (``launch.op_costs``) each call records ``forward_cost`` or
``backward_cost``; under the sanitizer (``kernels.sanitize``) the
forward's inputs, window and output are checked.  The forward's warps a
block are ``forward_plan``'s (a launch-config table, ``kernels.tiles``,
may set them).

``flash_attention_bwd`` is the gradient (``csrc/flash_attention_bwd.cu``,
which has no Pallas counterpart: the JAX package differentiates its XLA
attention; f32 or bf16, head_dim up to 256; f32: the five products in
3xTF32, one launch up to ``block_keys(hd)`` keys, two above; bf16
(``csrc/flash_attention_bwd_bf16.cuh``): on the bf16 tensor cores,
always two launches over ``backward_tiles``, the tiles the masks leave
empty skipped, ``walked_tiles``); ``flash_attention`` runs forward and
backward kernels as one ``torch.autograd.Function`` when an input
requires grad.

Bound on the H100: at the router's shapes the f32 operations (4*S*T*hd
per head, about 4 us for a router layer at B=32 on the CUDA cores); at
the zoo's bf16 prefill shapes the tensor cores' operations.  For f32
inputs the kernel runs both products on the TF32 tensor cores in
3xTF32, which keeps f32 accuracy; bf16 inputs have instances of their
own (``csrc/flash_attention_bf16.cu``) on the bf16 tensor cores: q k^T
in one pass, P V in two (P's bf16 pieces against the exact V).  The
online softmax is in registers and K/V tiles are staged in shared
memory with cp.async, so each block reads K and V once.  q, k, v are
f32 or bf16 (all one type; the output takes it), head_dim a multiple of
8 up to 256; the backward takes the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import build, sanitize, tiles
from repro_torch.launch import op_costs

NEG_INF = -2.3819763e38  # the Pallas kernel's mask fill
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)
WARPS = (1, 2, 4)     # warps a forward block can hold (kMaxWarps = 4)
SMS = 132             # the H100's SMs (kSMs in csrc/flash_attention.cuh)


def column_splits(hd: int, bf16: bool = False) -> int:
    """Blocks that share a query tile's output columns: the f32
    instances' ``Geometry::NC`` in ``csrc/flash_attention.cuh``, 1 up to
    head_dim 128, else 2; the bf16 instances (``flash_attention_bf16.cu``)
    hold every column in one block."""
    if bf16:
        return 1
    kd = hd // 8
    ko = kd if kd <= 16 else (kd + 1) // 2
    return -(-kd // ko)


def default_warps(B: int, S: int, H: int, hd: int, bf16: bool = False) -> int:
    """The forward kernel's own choice of warps a block (``warps`` 0):
    the most of 1, 2 or 4 that still gives every SM a block."""
    row_tiles = B * H * column_splits(hd, bf16) * -(-S // 16)
    warps = WARPS[-1]
    while warps > 1 and -(-row_tiles // warps) < SMS:
        warps //= 2
    return warps


def forward_plan(B: int, S: int, H: int, hd: int,
                 warps: int | None = None, bf16: bool = False) -> dict:
    """The forward kernel's launch geometry: ``warps`` a block, 16 query
    rows each (in the bf16 instances a pair of warps holds 16 rows, so a
    block has twice as many warps), unset: the launch-config table's
    entry at batch ``B``
    (``kernels.tiles``) where it is one of ``WARPS``, else 0, the
    kernel's own choice (``default_warps``).  ``launch_warps`` is what
    the wrapper passes to the kernel, ``warps`` what runs."""
    if warps is None:
        warps = tiles.tile_for("flash_attention", B, "warps", 0)
        if warps not in WARPS:
            warps = 0
    elif warps not in (0, *WARPS):
        raise ValueError(f"flash_attention: warps {warps} not in "
                         f"{(0, *WARPS)}")
    eff = warps or default_warps(B, S, H, hd, bf16)
    return {"launch_warps": warps, "warps": eff,
            "grid": (-(-S // (16 * eff)), B * H, column_splits(hd, bf16))}


def attention_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the masks leave for S queries over T keys
    (query i sees key j <= i when causal, j > i - window with a window):
    the work a masked call's data needs."""
    row = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, row - window + 1) if window > 0 else np.zeros_like(row)
    hi = np.minimum(row + 1, T) if causal else np.full_like(row, T)
    return int(np.maximum(0, hi - lo).sum())


def forward_cost(q, k, causal, window, with_lse=False) -> tuple[int, int]:
    """(operations, bytes) of one forward call: q k^T and P V over the
    pairs the masks leave (4 hd a head and pair); q, k, v read and o
    written once in their type, and the f32 log-sum-exp when written."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    nbytes = q.element_size() * (2 * B * S * H * hd + 2 * B * T * KV * hd)
    if with_lse:
        nbytes += 4 * B * H * S
    return 4 * B * H * hd * attention_pairs(S, T, causal, window), nbytes


def backward_cost(q, k, causal, window) -> tuple[int, int]:
    """(operations, bytes) of one backward call: its five products over
    the pairs the masks leave (10 hd a head and pair); q, k, v, dO and
    the f32 log-sum-exp read, dQ, dK, dV written once."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    nbytes = (q.element_size() * (3 * B * S * H * hd + 4 * B * T * KV * hd)
              + 4 * B * H * S)
    return 10 * B * H * hd * attention_pairs(S, T, causal, window), nbytes


def block_keys(hd: int) -> int:
    """Keys of one block of the f32 backward kernel
    (``csrc/flash_attention_bwd.cuh`` ``Geo::BK``): 128 up to head_dim
    128, 64 above."""
    return 128 if hd <= 128 else 64


def backward_launches(T: int, hd: int, bf16: bool = False) -> int:
    """Kernel launches of one backward call: f32, one when every key
    fits one block (head_dim up to 128), else two, the first writing
    each row's sums to a (B, H, S, 2) workspace; bf16, always those
    two."""
    if bf16:
        return 2
    return 1 if T <= block_keys(hd) and hd <= 128 else 2


def backward_tiles(hd: int) -> dict:
    """The bf16 backward's tiles (``csrc/flash_attention_bwd_bf16.cuh``
    ``Bf16Bwd``), (query rows, keys) of each launch: the dQ launch's
    tiles of 64 rows against key blocks of 64 keys, then the dK/dV
    launch's blocks of 64 keys (32 above head_dim 128) against tiles of
    64 rows."""
    wide = -(-hd // 16) * 16 > 128
    return {"dq": (64, 64), "kv": (64, 32 if wide else 64)}


def key_range(row_lo: int, row_hi: int, T: int, causal: bool,
              window: int) -> tuple[int, int]:
    """Keys [lo, hi) that some row of [row_lo, row_hi] may see under the
    masks: the kernels' rule for the tiles they skip, by which a tile
    whose rows include one that sees no key at all (past T with a
    window: its P is uniform over every key) keeps every key."""
    lo, hi = 0, T
    if window <= 0 or row_hi - window + 1 <= T - 1:
        if causal:
            hi = min(T, row_hi + 1)
        if window > 0:
            lo = max(0, row_lo - window + 1)
    return lo, hi


def walked_tiles(S: int, T: int, rows: int, keys: int, causal: bool,
                 window: int) -> list[tuple[int, int]]:
    """The (query tile, key block) pairs, tiles of ``rows`` queries and
    blocks of ``keys`` keys, that the bf16 kernels compute: those where
    ``key_range`` of the tile's rows meets the block.  The forward takes
    (16 x warps, 64 or 32 above head_dim 128), the backward's launches
    ``backward_tiles``."""
    out = []
    for qt in range(-(-S // rows)):
        lo, hi = key_range(qt * rows, min(S, qt * rows + rows) - 1, T,
                           causal, window)
        out += [(qt, kb) for kb in range(-(-T // keys))
                if lo <= min(T, kb * keys + keys) - 1 and kb * keys < hi]
    return out


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


def _forward(q, k, v, causal, window, softcap, with_lse, warps=None):
    """Launch the forward kernel: (o, lse or None); on meta tensors
    their shapes alone."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    _check_head_dim(hd)
    plan = forward_plan(B, S, H, hd, warps, q.dtype == torch.bfloat16)
    if q.device.type != "meta":
        q, k, v = _kernel_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.device.type == "meta":
        return o, lse
    build.launch(
        "tryage_flash_attention", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), 0 if lse is None else lse.data_ptr(),
        B, S, T, H, KV, hd, int(causal), int(window), float(softcap),
        1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
        plan["launch_warps"])
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
    (B, H, S) f32 and the output gradient ``do`` (q's type):
    ``csrc/flash_attention_bwd.cu`` on CUDA tensors (``backward_launches``:
    one launch, or a first for the row sums and dQ, then dK and dV), the
    plain version's autograd on CPU ones (``lse`` unused there), the
    gradients' shapes alone on meta ones.  The gradients take the
    inputs' type."""
    _check(q, k, v)
    return op_costs.kernel_call(
        "flash_attention_bwd", lambda: backward_cost(q, k, causal, window),
        _backward, q, k, v, lse, do, causal, window, softcap)


def _backward(q, k, v, lse, do, causal, window, softcap):
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        return attention_grad_plain(q, k, v, do, causal=causal,
                                    window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (do.shape != q.shape or do.dtype != q.dtype
            or lse.shape != (B, H, S) or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    _check_head_dim(hd)
    q, k, v, do, lse = _kernel_inputs(q, k, v, do, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = (torch.empty(B, H, S, 2, dtype=torch.float32, device=q.device)
            if backward_launches(T, hd, q.dtype == torch.bfloat16) == 2
            else None)
    build.launch(
        "tryage_flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        None if rows is None else rows.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, T, H, KV, hd, int(causal),
        int(window), float(softcap), 1.0 / math.sqrt(hd),
        int(q.dtype == torch.bfloat16))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (keeping its log-sum-exp) and the backward
    kernel as one differentiable op on CUDA (or meta) tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, warps):
        o, lse = _forward(q, k, v, causal, window, softcap, True, warps)
        ctx.save_for_backward(q, k, v, lse)
        ctx.masks = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        causal, window, softcap = ctx.masks
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, do, causal=causal,
                                         window=window, softcap=softcap)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    warps=None):
    """Attention over (B, S, H, hd) queries and (B, T, KV, hd) keys and
    values; the kernel on CUDA tensors, the plain version on CPU ones,
    the output's shape alone on meta ones (the dry run).  On CUDA or
    meta tensors that need a gradient it runs as ``_FlashAttention``,
    whose backward is ``flash_attention_bwd``; otherwise the forward
    kernel alone, with no log-sum-exp written.  ``warps``: the launch
    geometry (``forward_plan``; unset: the table's, else the kernel's
    own).  Under the sanitizer q, k, v, the window and the output are
    checked after the call."""
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    lse = grad and q.device.type != "cpu"
    out = op_costs.kernel_call(
        "flash_attention", lambda: forward_cost(q, k, causal, window, lse),
        _attention, q, k, v, causal, window, softcap, warps, grad)
    if sanitize.wrapper_checks():
        T = k.shape[1]
        sanitize.run_checks(
            sanitize.check_finite("flash_attention", "input", q, k, v),
            # window == 0 disables banding; valid band widths are 0..T
            sanitize.check_in_range("flash_attention", "window", window, 0,
                                    T + 1),
            sanitize.check_finite("flash_attention", "output", out))
    return out


def _attention(q, k, v, causal, window, softcap, warps, grad):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    if grad:
        return _FlashAttention.apply(q, k, v, causal, window, softcap, warps)
    return _forward(q, k, v, causal, window, softcap, False, warps)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
