"""The gradient of the port's attention against the JAX package's.

``attention_plain`` (the CPU path of ``flash_attention``, differentiated
by torch autograd) against ``jax.grad`` of the reference oracle
``repro.kernels.flash_attention.ref.attention_ref`` (K/V repeated for
GQA) and of the whole attention block ``attend_full(impl="xla")``
(projections, RoPE, masks), for causal, sliding-window, softcap and GQA
cases, at head_dim 256 (gemma3's) too, and in bf16 (both sides compute
in f32 and round the gradients to bf16: within one bf16 ulp of the
reference's, plus 1e-5 of the largest).  Then a CPU emulation of the
backward kernel's order of work (``csrc/flash_attention_bwd.cu``: per
block of up to 128 keys (64 above head_dim 128) and tile of query rows,
S^T and dP^T key-major, P from the forward's
log-sum-exp, each row renormalised by its own sum of P with D = sum(P
dP) / sum(P) (from the same pass up to 128 keys, from a first pass
over the key blocks past it), dS = P (dP - D) with the softcap factor,
masked scores given no gradient, a fully masked row's uniform P, and
the GQA sum over query heads) against torch autograd, also from a
log-sum-exp put off per row, so that a fault of the algorithm shows
before the card.  The emulation runs its five products in f32, and in
the TF32 rounding of the tensor cores (``test_torch_tf32.py``).

Tolerance: each gradient's max abs error within 1e-5 of its largest
magnitude in f32 (sums in other orders); with the products in 3xTF32
within ``chip_smoke.ATTN_GRAD_REL_TOL`` (1e-4, the card's gate), which
one TF32 pass misses.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as tattn
from repro_torch.models.common import AttnConfig as TAttn
from repro_torch.models.common import ModelConfig as TCfg
from test_torch_tf32 import MMS, chip_smoke
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.common import AttnConfig as JAttn  # noqa: E402
from repro.models.common import ModelConfig as JCfg  # noqa: E402

REL = 1e-5
# (B, S, T, H, KV, hd, causal, window, softcap)
CASES = [
    (2, 16, 16, 4, 4, 8, False, 0, 0.0),
    (2, 16, 16, 4, 4, 8, True, 0, 0.0),
    (2, 24, 24, 4, 2, 8, True, 5, 0.0),
    (2, 16, 16, 4, 1, 16, False, 0, 3.0),
    (1, 40, 40, 6, 3, 8, True, 7, 2.0),
    (1, 20, 8, 2, 2, 8, False, 3, 0.0),    # rows 10.. see no key at all
]
# head_dim 256: a local window and a global causal layer, as gemma3's
WIDE = [
    (1, 24, 24, 2, 1, 256, True, 8, 0.0),
    (1, 20, 20, 2, 2, 256, True, 0, 0.0),
]


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= REL * scale, (what, np.abs(
        got - want).max(), scale)


def _inputs(B, S, T, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                      (B, S, H, hd))]


def _torch_grads(q, k, v, do, **masks):
    return [g.numpy() for g in fa_ops.attention_grad_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)), **masks)]


def _jax_grads(q, k, v, do, H, KV, **masks):
    """jax.grad of ``attention_ref`` (K/V repeated for GQA) for the
    output gradient ``do``, in the inputs' type."""
    B, S, _, hd = q.shape

    def ref(q, k, v):
        k, v = (jnp.repeat(a, H // KV, axis=2) for a in (k, v))
        bh = lambda a: a.transpose(0, 2, 1, 3).reshape(
            B * H, a.shape[1], hd)
        o = attention_ref(bh(q), bh(k), bh(v), **masks)
        o = o.reshape(B, H, S, hd).transpose(0, 2, 1, 3)
        return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))

    return jax.grad(ref, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("case", CASES + WIDE)
def test_plain_grad_matches_jax_reference(case):
    B, S, T, H, KV, hd, causal, window, softcap = case
    q, k, v, do = _inputs(B, S, T, H, KV, hd)
    masks = dict(causal=causal, window=window, softcap=softcap)
    want = _jax_grads(q, k, v, do, H, KV, **masks)
    got = _torch_grads(q, k, v, do, **masks)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, name)


@pytest.mark.parametrize("case", [CASES[1], CASES[4], WIDE[0], WIDE[1]])
def test_plain_grad_bf16_matches_jax_reference(case):
    B, S, T, H, KV, hd, causal, window, softcap = case
    masks = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16)
                   for a in _inputs(B, S, T, H, KV, hd))
    want = [np.asarray(w.astype(jnp.float32), np.float64)
            for w in _jax_grads(q, k, v, do, H, KV, **masks)]
    got = fa_ops.attention_grad_plain(
        *(torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in (q, k, v, do)), **masks)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy().astype(np.float64)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                      - 7)
        err = np.abs(g - w)
        assert (err <= ulp + REL * np.abs(w).max()).all(), (
            name, float((err - ulp).max()))


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == c[2]])
def test_attend_full_grad_matches_xla(case):
    B, S, _, H, KV, hd, causal, window, softcap = case
    d = 16
    kw = dict(name="t", family="dense", num_layers=1, d_model=d,
              num_heads=H, num_kv_heads=KV, head_dim=hd, d_ff=32,
              vocab_size=32, dtype="float32")
    jcfg = JCfg(attn=JAttn(causal=causal, softcap=softcap), **kw)
    tcfg = TCfg(attn=TAttn(causal=causal, softcap=softcap), **kw)
    rng = np.random.default_rng(1)
    p = {"wq": rng.standard_normal((d, H, hd)) / 4,
         "wk": rng.standard_normal((d, KV, hd)) / 4,
         "wv": rng.standard_normal((d, KV, hd)) / 4,
         "wo": rng.standard_normal((H, hd, d)) / 4}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    dy = rng.standard_normal((B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))

    def jloss(p, x):
        y, _ = jattn.attend_full(p, x, jcfg, jnp.asarray(pos), window,
                                 impl="xla")
        return jnp.sum(y * dy)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, x)
    tp = {n: torch.tensor(a, requires_grad=True) for n, a in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, _ = tattn.attend_full(tp, tx, tcfg, torch.from_numpy(pos.copy()),
                             window)
    (y * torch.from_numpy(dy)).sum().backward()
    _close(tx.grad.numpy(), jgx, "x")
    for n in p:
        _close(tp[n].grad.numpy(), jgp[n], n)


# ------------------------------------------- the backward kernel, emulated

NEG_INF = np.float32(fa_ops.NEG_INF)


def _scores(q, k, scale, softcap):
    """(B, H, S, T) scores from pre-scaled q, and tanh of the softcap."""
    s = torch.einsum("bshd,bthd->bhst", q * scale, k)
    th = None
    if softcap > 0:
        th = torch.tanh(s / softcap)
        s = softcap * th
    return s, th


def _allowed(S, T, causal, window):
    qi = torch.arange(S)[:, None]
    kj = torch.arange(T)[None, :]
    ok = torch.ones(S, T, dtype=torch.bool)
    if causal:
        ok &= kj <= qi
    if window > 0:
        ok &= kj > qi - window
    return ok


def _forward_lse(q, k, v, causal, window, softcap):
    """The forward kernel's o and lse = m + log(max(l, 1e-30))."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    kr, vr = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s, _ = _scores(q, kr, 1 / math.sqrt(hd), softcap)
    s = torch.where(_allowed(S, T, causal, window), s,
                    torch.tensor(NEG_INF))
    m = s.max(-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhst,bthd->bshd", p / l.clamp_min(1e-30), vr)
    return o, (m + torch.log(l.clamp_min(1e-30)))[..., 0]


def _block_scores(qt, dot, kb, vb, rows, keys, lse_t, S, T, scale, masks,
                  mm):
    """One key block against one query tile, key-major as the kernel
    computes them: P^T from S^T = K q^T and the forward's lse (the
    uniform 1 / T on a row with no key), dP^T = V dO^T, the softcap
    factor, and which rows have no key."""
    st = mm(kb, qt.T) * scale
    dpt = mm(vb, dot.T)
    dcap = torch.ones_like(st)
    if masks["softcap"] > 0:
        th = torch.tanh(st / masks["softcap"])
        st, dcap = masks["softcap"] * th, 1 - th * th
    inb = (keys[:, None] < T) & (rows[None, :] < S)
    ok = inb.clone()
    if masks["causal"]:
        ok &= keys[:, None] <= rows[None, :]
    if masks["window"] > 0:
        ok &= keys[:, None] > rows[None, :] - masks["window"]
    dead = (lse_t <= NEG_INF)[None, :]
    uniform = torch.tensor(1.0) / T
    p = torch.where(dead, torch.where(inb, uniform, 0.0),
                    torch.where(ok, torch.exp(st - lse_t[None, :]), 0.0))
    return p, dpt, dcap, dead


def _row_stats(p, dpt, dead):
    """1 / sum P (1 on a row with no key) and D = sum(P dP) / sum(P)."""
    ps, pd = p.sum(0), (p * dpt).sum(0)
    live = ps > 0
    inv = torch.where(dead[0] | ~live, 1.0, 1.0 / torch.where(live, ps, 1.0))
    return inv, torch.where(live, pd / torch.where(live, ps, 1.0), 0.0)


def _grads(p, dpt, dcap, dead, inv, dd):
    """P / sum P and dS^T = P (dP - D) times the softcap factor."""
    pb = p * inv[None, :]
    return pb, torch.where(dead, 0.0, pb * (dpt - dd[None, :]) * dcap)


def _emulated_bwd(q, k, v, lse, do, causal, window, softcap,
                  mm=torch.matmul):
    """The backward kernel's order of work, with its five products
    through ``mm``.  Up to ``block_keys(hd)`` keys at head_dim up to
    128 (one launch): per (b, kv
    head), per query head of the group and tile of rows, S^T and dP^T
    once, the row sums from that same pass, dV += P^T dO, dK += dS^T q,
    and dQ of the tile, complete.  Past it (two launches): per (b, h,
    tile) the key blocks for the row sums, then again for dS and dQ;
    then per (b, kv head, key block) the tiles as above with the row
    sums read."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, torch.tensor(1 / math.sqrt(hd))
    R, NB = (64 if hd <= 64 else 32), fa_ops.block_keys(hd)
    masks = dict(causal=causal, window=window, softcap=softcap)
    whole = fa_ops.backward_launches(T, hd) == 1
    n_kb = -(-T // NB)
    dq, dk, dv = (torch.zeros_like(a) for a in (q, k, v))

    def pad(x, n):  # rows past the end read as zero
        return torch.cat([x, x.new_zeros(n - x.shape[0], *x.shape[1:])])

    def tile(b, h, q0):
        rows = torch.arange(q0, q0 + R)
        lse_t = pad(lse[b, h, q0:q0 + R], R)
        return (rows, pad(q[b, q0:q0 + R, h], R), pad(do[b, q0:q0 + R, h], R),
                lse_t)

    def block(b, kvh, k0):
        return (torch.arange(k0, k0 + NB), pad(k[b, k0:k0 + NB, kvh], NB),
                pad(v[b, k0:k0 + NB, kvh], NB))

    stats = {}
    if not whole:                                       # the dQ launch
        for b in range(B):
            for h in range(H):
                for q0 in range(0, S, R):
                    rows, qt, dot, lse_t = tile(b, h, q0)
                    ps = pd = 0
                    for k0 in range(0, T, NB):
                        keys, kb, vb = block(b, h // G, k0)
                        p, dpt, _, dead = _block_scores(
                            qt, dot, kb, vb, rows, keys, lse_t, S, T, scale,
                            masks, mm)
                        ps, pd = ps + p.sum(0), pd + (p * dpt).sum(0)
                    live = ps > 0
                    inv = torch.where(dead[0] | ~live, 1.0,
                                      1.0 / torch.where(live, ps, 1.0))
                    dd = torch.where(live, pd / torch.where(live, ps, 1.0),
                                     0.0)
                    stats[b, h, q0] = inv, dd
                    acc = 0
                    for k0 in range(0, T, NB):
                        keys, kb, vb = block(b, h // G, k0)
                        p, dpt, dcap, dead = _block_scores(
                            qt, dot, kb, vb, rows, keys, lse_t, S, T, scale,
                            masks, mm)
                        _, dst = _grads(p, dpt, dcap, dead, inv, dd)
                        acc = acc + mm(dst.T, kb)
                    n = min(R, S - q0)
                    dq[b, q0:q0 + n, h] = (acc * scale)[:n]
    for b in range(B):                                  # the dK/dV launch
        for kvh in range(KV):
            for k0 in range(0, T, NB):
                keys, kb, vb = block(b, kvh, k0)
                ak = av = 0
                for h in range(kvh * G, kvh * G + G):
                    for q0 in range(0, S, R):
                        rows, qt, dot, lse_t = tile(b, h, q0)
                        p, dpt, dcap, dead = _block_scores(
                            qt, dot, kb, vb, rows, keys, lse_t, S, T, scale,
                            masks, mm)
                        inv, dd = (_row_stats(p, dpt, dead) if whole
                                   else stats[b, h, q0])
                        pb, dst = _grads(p, dpt, dcap, dead, inv, dd)
                        av = av + mm(pb, dot)
                        ak = ak + mm(dst, qt)
                        if whole:
                            n = min(R, S - q0)
                            dq[b, q0:q0 + n, h] = (mm(dst.T, kb) * scale)[:n]
                n = min(NB, T - k0)
                dk[b, k0:k0 + n, kvh] = (ak * scale)[:n]
                dv[b, k0:k0 + n, kvh] = av[:n]
    return dq, dk, dv


# the switch between the kernel's one-launch and two-launch paths, hd 128
# (tiles of 32 rows), long causal windows, and hd 256 (blocks of 64 keys,
# always two launches)
PATH_CASES = [
    (1, 70, 70, 2, 1, 256, True, 16, 0.0),
    (2, 96, 128, 4, 2, 40, False, 0, 0.0),
    (2, 96, 129, 4, 2, 40, False, 0, 2.0),
    (1, 64, 64, 2, 2, 128, True, 0, 0.0),
    (1, 300, 300, 2, 1, 64, True, 64, 0.0),
    (1, 300, 140, 2, 2, 8, False, 3, 0.0),     # rows 142.. see no key
]


def _grad_case(case):
    """Inputs, masks, autograd's gradients of the plain version, and the
    forward's log-sum-exp as is and put off by up to 1e-3 per row (the
    card's 3xTF32 forward against the backward's recompute, much
    magnified): the row sums renormalise P, so both give the same
    gradients."""
    B, S, T, H, KV, hd, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, KV, hd,
                                                         seed=3))
    masks = dict(causal=causal, window=window, softcap=softcap)
    o, lse = _forward_lse(q, k, v, **masks)
    _close(o.numpy(), fa_ops.attention_plain(q, k, v, **masks).numpy(), "o")
    want = fa_ops.attention_grad_plain(q, k, v, do, **masks)
    off = torch.from_numpy(np.random.default_rng(4).uniform(
        -1e-3, 1e-3, lse.shape).astype(np.float32))
    return (q, k, v, do), masks, want, (
        lse, torch.where(lse > NEG_INF, lse + off, lse))


@pytest.mark.parametrize("case", CASES + [
    (2, 40, 37, 4, 2, 24, True, 0, 0.0),     # ragged tiles both ways
    (1, 70, 70, 2, 1, 8, False, 9, 1.5),
] + PATH_CASES)
def test_backward_algorithm_matches_autograd(case):
    (q, k, v, do), masks, want, lses = _grad_case(case)
    for lse_in in lses:
        got = _emulated_bwd(q, k, v, lse_in, do, **masks)
        for name, g, w in zip("qkv", got, want):
            _close(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("scheme", ["3xtf32", "3xtf32_rz", "1xtf32"])
@pytest.mark.parametrize("case", CASES + PATH_CASES)
def test_backward_tf32_within_tolerance(case, scheme):
    """The kernel's order of work with its products (P and dS among their
    operands) in 3xTF32 holds the card's gate, with small rounded and
    truncated (the kernel's split); in one TF32 pass it misses it."""
    (q, k, v, do), masks, want, lses = _grad_case(case)
    tol = chip_smoke.ATTN_GRAD_REL_TOL
    for lse_in in lses:
        got = _emulated_bwd(q, k, v, lse_in, do, **masks, mm=MMS[scheme])
        rel = max(float((g - w).abs().max()) / float(w.abs().max())
                  for g, w in zip(got, want))
        if scheme.startswith("3x"):
            assert rel <= tol, rel
        else:
            assert rel > tol, rel


def test_flash_attention_is_differentiable_on_the_cpu():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 8))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    want = fa_ops.flash_attention_bwd(q, k, v, None, do, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fa_ops.flash_attention_bwd.launches == 0
