"""The numerics the port's tensor-core kernels rest on, emulated on the CPU.

``csrc/flash_attention.cu`` and ``csrc/mlstm_scan.cu`` run their f32
products on the TF32 tensor cores in 3xTF32: each operand x is split
into big = tf32(x) and small = tf32(x - big), and a product takes
small*big + big*small + big*big with f32 accumulation.  This file
emulates the rounding ``cvt.rna.tf32.f32`` performs (add 0x1000 to the
bits, clear the low 13) in torch on numpy-seeded inputs and shows that
3xTF32 stays within the card's f32 gates (``chip_smoke.py``'s
``ATTN_TOL`` and ``MLSTM_REL_TOL``, the tolerances of
``tests/test_torch_gpu.py``) while a single TF32 pass does not.  So the
kernels keep the tolerances of their f32 predecessors.
``csrc/flash_attention_bwd.cu`` leaves small as the f32 difference
x - big, which the tensor cores truncate to TF32 (``tf32_rz``,
``mm_3xtf32_rz``; its gate is held in ``test_torch_attention_grad.py``).
The bf16 attention kernels (``csrc/flash_attention_bf16.cu``,
``csrc/flash_attention_bwd_bf16.cuh``) run on the bf16 tensor cores: a
product of two bf16 inputs in one pass, a product with a computed f32
operand (P, dS) in that operand's bf16 pieces (``bf16_pieces``,
``split_bf16`` of ``csrc/mma_bf16.cuh``) against the exact input.  Two
pieces hold the card's bf16 gates (one bf16 ulp plus ``ATTN_TOL`` for
the forward, plus ``ATTN_GRAD_REL_TOL`` of the largest for the
backward); one piece fails them.
No card needed.
"""

import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mlstm_scan import ops as ml_ops

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
ATTN_TOL = chip_smoke.ATTN_TOL
MLSTM_REL_TOL = chip_smoke.MLSTM_REL_TOL


def tf32(x):
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, nearest, ties
    away from zero; the result is an f32 with its low 13 bits clear."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_rz(x):
    """What the tensor cores read of an f32 operand: its top 19 bits (the
    low 13 dropped, a truncation toward zero)."""
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b, small=tf32):
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = small(a - a_big), small(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_3xtf32_rz(a, b):
    """3xTF32 with small left unrounded for the tensor cores to truncate
    (``split_tf32_rz`` of ``csrc/mma_tf32.cuh``)."""
    return mm_3xtf32(a, b, small=tf32_rz)


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def bf16(x):
    """x rounded to bf16 (to nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_pieces(x, n):
    """x's first n bf16 pieces, each rounded to nearest: hi = bf16(x),
    lo = bf16(x - hi), ... (two: ``split_bf16``)."""
    out, rest = [], x
    for _ in range(n):
        out.append(bf16(rest))
        rest = rest - out[-1]
    return out


def mm_bf16(a, b, pieces):
    """a @ b on the bf16 tensor cores as the bf16 kernels run it: a (a
    computed f32 operand, or an exact bf16 input, whose pieces past the
    first are zero) in ``pieces`` bf16 pieces, each against b (a bf16
    input, exact), the small piece first, summed in f32."""
    out = None
    for p in reversed(bf16_pieces(a, pieces)):
        t = p @ bf16(b)
        out = t if out is None else out + t
    return out


MMS = {"3xtf32": mm_3xtf32, "3xtf32_rz": mm_3xtf32_rz, "1xtf32": mm_1xtf32,
       "bf16x2": functools.partial(mm_bf16, pieces=2),
       "bf16x1": functools.partial(mm_bf16, pieces=1)}


def bf16_ulps_past(got, ref, tol):
    """The largest miss of ``chip_smoke.py``'s bf16 gates, in bf16 ulps
    of the larger magnitude: (|got - ref| - tol) / ulp, at most 1 passes."""
    diff = (got.float() - ref.float()).abs()
    ulp = chip_smoke.bf16_ulp(torch, torch.maximum(got.float().abs(),
                                                   ref.float().abs()))
    return float(((diff - tol).clamp_min(0) / ulp).max())


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -11 - 2 ** -23])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0])
    assert torch.equal(tf32(x), want)
    # big + small keeps 22 of the 24 bits
    big = tf32(x)
    assert ((big + tf32(x - big)) - x).abs().max() <= 2 ** -22 * 2


def test_truncated_small_half_keeps_22_bits():
    """big + truncated small is within 2^-22 of |x| (2^-23 rounded)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    big = tf32(x)
    for small, bound in ((tf32, 2.0 ** -23), (tf32_rz, 2.0 ** -22)):
        err = ((big + small(x - big)) - x).abs() / x.abs()
        assert float(err.max()) <= bound, (small.__name__, float(err.max()))


def attention_emulated(q, k, v, mm, prescale=True):
    """Non-causal attention as the kernel computes it, with its two
    products through ``mm``: q scaled before q k^T (the f32 instances)
    or S after it (``prescale`` False: the bf16 instances)."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    qh = (q * (scale if prescale else 1.0)).permute(0, 2, 1, 3)
    s = mm(qh, k.permute(0, 2, 3, 1)) * (1.0 if prescale else scale)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = mm(p, v.permute(0, 2, 1, 3)) / p.sum(-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


@pytest.mark.parametrize("hd", [32, 40])
@pytest.mark.parametrize("scheme", ["3xtf32", "1xtf32", "bf16x2", "bf16x1"])
def test_attention_3xtf32_within_tolerance(hd, scheme):
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 128, 4, hd),
                                                    dtype=np.float32))
               for _ in range(3))
    if scheme.startswith("bf16"):
        # bf16 inputs: o rounded to bf16 against the plain version's
        # (chip_smoke.py's parity gate)
        q, k, v = (x.bfloat16() for x in (q, k, v))
        ref = fa_ops.attention_plain(q, k, v, causal=False)
        got = attention_emulated(q.float(), k.float(), v.float(),
                                 MMS[scheme], prescale=False).bfloat16()
        ulps = bf16_ulps_past(got, ref, ATTN_TOL)
        if scheme == "bf16x2":
            assert ulps <= 1.0, ulps
        else:
            assert ulps > 1.0, ulps
        return
    ref = fa_ops.attention_plain(q, k, v, causal=False)
    err = float((attention_emulated(q, k, v, MMS[scheme]) - ref).abs().max())
    if scheme == "3xtf32":
        assert err <= ATTN_TOL, err
    else:
        assert err > ATTN_TOL, err


def mlstm_chunk_emulated(q, k, v, i_pre, f_pre, state, mm):
    """One chunk (S = L) of the mLSTM as the kernel computes it: q k^T,
    q C, P v and k^T v through ``mm``; q . n and the sums of P and of
    k w in f32 on the CUDA cores."""
    B, L, H, dh = q.shape
    qs = (q * (1.0 / math.sqrt(dh))).permute(0, 2, 1, 3)      # (B,H,L,dh)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    C, n, m = state["C"], state["n"], state["m"]
    F = torch.cumsum(ml_ops.log_sigmoid(f_pre), dim=1).transpose(1, 2)
    ih = i_pre.transpose(1, 2)                                # (B,H,L)
    g = torch.cummax(ih - F, dim=2).values
    m_t = F + torch.maximum(m[..., None], g)
    a = torch.exp(F + m[..., None] - m_t)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    W = torch.where(causal, torch.exp((F - m_t)[..., :, None]
                                      + (ih - F)[..., None, :]),
                    torch.zeros(()))
    P = W * mm(qs, kh.transpose(2, 3))
    num = a[..., None] * mm(qs, C) + mm(P, vh)
    den = a * (qs * n[:, :, None]).sum(-1) + P.sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    m_last = m_t[..., -1]
    kw = kh * torch.exp(F[..., -1:] - F + ih - m_last[..., None])[..., None]
    decay = torch.exp(F[..., -1] + m - m_last)
    C1 = decay[..., None, None] * C + mm(kw.transpose(2, 3), vh)
    n1 = decay[..., None] * n + kw.sum(2)
    return h.permute(0, 2, 1, 3), {"C": C1, "n": n1, "m": m_last}


@pytest.mark.parametrize("scheme", ["3xtf32", "1xtf32"])
def test_mlstm_chunk_3xtf32_within_tolerance(scheme):
    """A chunk of 64 steps at dh 1024 from a carried state, as the card
    tests draw it (forget gates biased by +3, state scaled by 0.3)."""
    B, L, H, dh = 1, 64, 2, 1024
    rng = np.random.default_rng(7)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    q, k, v = r(B, L, H, dh), r(B, L, H, dh), r(B, L, H, dh)
    i_pre, f_pre = r(B, L, H), r(B, L, H) + 3.0
    state = {"C": r(B, H, dh, dh) * 0.3, "n": r(B, H, dh) * 0.3,
             "m": r(B, H)}
    ref_h, ref = ml_ops.mlstm_chunkwise_plain(q, k, v, i_pre, f_pre, state)
    h, got = mlstm_chunk_emulated(q, k, v, i_pre, f_pre, state, MMS[scheme])
    rel = {name: float((x - y).abs().max()) / float(y.abs().max())
           for name, x, y in (("h", h, ref_h), ("C", got["C"], ref["C"]),
                              ("n", got["n"], ref["n"]),
                              ("m", got["m"], ref["m"]))}
    if scheme == "3xtf32":
        assert max(rel.values()) <= MLSTM_REL_TOL, rel
    else:
        assert max(rel.values()) > MLSTM_REL_TOL, rel
