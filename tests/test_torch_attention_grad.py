"""The gradient of the port's attention against the JAX package's.

``attention_plain`` (the CPU path of ``flash_attention``, differentiated
by torch autograd) against ``jax.grad`` of the reference oracle
``repro.kernels.flash_attention.ref.attention_ref`` (K/V repeated for
GQA) and of the whole attention block ``attend_full(impl="xla")``
(projections, RoPE, masks), for causal, sliding-window, softcap and GQA
cases.  Then a CPU emulation of the backward kernel's algorithm
(``csrc/flash_attention_bwd.cu``: P recomputed per 32 x 32 tile from
the forward's log-sum-exp, each row renormalised by its own sum of P
with D = sum(P dP) / sum(P), dS = P (dP - D) with the softcap factor,
masked scores given no gradient, a fully masked row's uniform P, and
the GQA sum over query heads) against torch autograd, also from a
log-sum-exp put off per row, so that a fault of the algorithm shows
before the card.

Tolerance: each gradient's max abs error within 1e-5 of its largest
magnitude (f32 sums in other orders).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as tattn
from repro_torch.models.common import AttnConfig as TAttn
from repro_torch.models.common import ModelConfig as TCfg

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


@pytest.mark.parametrize("case", CASES)
def test_plain_grad_matches_jax_reference(case):
    B, S, T, H, KV, hd, causal, window, softcap = case
    q, k, v, do = _inputs(B, S, T, H, KV, hd)
    masks = dict(causal=causal, window=window, softcap=softcap)

    def ref(q, k, v):
        k, v = (jnp.repeat(a, H // KV, axis=2) for a in (k, v))
        bh = lambda a: a.transpose(0, 2, 1, 3).reshape(
            B * H, a.shape[1], hd)
        o = attention_ref(bh(q), bh(k), bh(v), **masks)
        o = o.reshape(B, H, S, hd).transpose(0, 2, 1, 3)
        return jnp.sum(o * do)

    want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    got = _torch_grads(q, k, v, do, **masks)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, name)


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
    y = tattn.attend_full(tp, tx, tcfg, torch.from_numpy(pos.copy()), window)
    (y * torch.from_numpy(dy)).sum().backward()
    _close(tx.grad.numpy(), jgx, "x")
    for n in p:
        _close(tp[n].grad.numpy(), jgp[n], n)


# ------------------------------------------- the backward kernel, emulated

NEG_INF = np.float32(fa_ops.NEG_INF)
TILE = 32


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


def _emulated_bwd(q, k, v, lse, do, causal, window, softcap):
    """The two backward launches, tile by tile, in f32: the dQ launch's
    statistics pass (each row's sum of P and of P dP over all keys, so
    lse_b = lse + log(sum P) and D = sum(P dP) / sum(P)), its dQ pass,
    then the dK/dV launch on lse_b and D."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, 1 / math.sqrt(hd)
    lse_b, dsum = lse.clone(), torch.zeros_like(lse)
    dq, dk, dv = (torch.zeros_like(a) for a in (q, k, v))

    def tile(b, h, q0, k0, lse, dsum):
        rows = torch.arange(q0, q0 + TILE)
        keys = torch.arange(k0, k0 + TILE)
        rin, kin = rows < S, keys < T
        rc, kc = rows.clamp(max=S - 1), keys.clamp(max=T - 1)
        qs = torch.where(rin[:, None], q[b, rc, h] * scale, 0.0)
        dos = torch.where(rin[:, None], do[b, rc, h], 0.0)
        ks = torch.where(kin[:, None], k[b, kc, h // G], 0.0)
        vs = torch.where(kin[:, None], v[b, kc, h // G], 0.0)
        s, dp = qs @ ks.T, dos @ vs.T
        th = None
        if softcap > 0:
            th = torch.tanh(s / softcap)
            s = softcap * th
        inb = rin[:, None] & kin[None, :]
        ok = inb.clone()
        if causal:
            ok &= keys[None, :] <= rows[:, None]
        if window > 0:
            ok &= keys[None, :] > rows[:, None] - window
        lse_t = torch.where(rin, lse[b, h, rc], 0.0)[:, None]
        d_t = torch.where(rin, dsum[b, h, rc], 0.0)[:, None]
        dead = lse_t <= NEG_INF
        p = torch.where(ok, torch.exp(s - lse_t), 0.0)
        p = torch.where(dead, torch.where(inb, 1.0 / T, 0.0), p)
        ds = torch.where(ok & ~dead, p * (dp - d_t), 0.0)
        if th is not None:
            ds = ds * (1 - th * th)
        return qs, dos, ks, p, dp, ds, rin, kin, rc, kc

    for b in range(B):
        for h in range(H):                                  # dQ launch
            for q0 in range(0, S, TILE):
                ps = pd = 0
                for k0 in range(0, T, TILE):
                    _, _, _, p, dp, _, rin, _, rc, _ = tile(
                        b, h, q0, k0, lse, dsum)
                    ps, pd = ps + p.sum(1), pd + (p * dp).sum(1)
                r = rc[rin]
                live = (lse[b, h, r] > NEG_INF) & (ps[rin] > 0)
                lse_b[b, h, r] = torch.where(
                    live, lse[b, h, r] + torch.log(ps[rin]), lse[b, h, r])
                dsum[b, h, r] = torch.where(ps[rin] > 0, pd[rin] / ps[rin],
                                            0.0)
                acc = 0
                for k0 in range(0, T, TILE):
                    _, _, ks, _, _, ds, rin, _, rc, _ = tile(
                        b, h, q0, k0, lse_b, dsum)
                    acc = acc + ds @ ks
                dq[b, rc[rin], h] = (acc * scale)[rin]
        for kvh in range(KV):                               # dK/dV launch
            for k0 in range(0, T, TILE):
                ak = av = 0
                for h in range(kvh * G, kvh * G + G):
                    for q0 in range(0, S, TILE):
                        qs, dos, _, p, _, ds, _, kin, _, kc = tile(
                            b, h, q0, k0, lse_b, dsum)
                        av = av + p.T @ dos
                        ak = ak + ds.T @ qs
                dk[b, kc[kin], kvh] = ak[kin]
                dv[b, kc[kin], kvh] = av[kin]
    return dq, dk, dv


@pytest.mark.parametrize("case", CASES + [
    (2, 40, 37, 4, 2, 24, True, 0, 0.0),     # ragged tiles both ways
    (1, 70, 70, 2, 1, 8, False, 9, 1.5),
])
def test_backward_algorithm_matches_autograd(case):
    B, S, T, H, KV, hd, causal, window, softcap = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, S, T, H, KV, hd,
                                                         seed=3))
    masks = dict(causal=causal, window=window, softcap=softcap)
    o, lse = _forward_lse(q, k, v, **masks)
    _close(o.numpy(), fa_ops.attention_plain(q, k, v, **masks).numpy(), "o")
    want = fa_ops.attention_grad_plain(q, k, v, do, **masks)
    # a forward whose log-sum-exp is off by a per-row amount (the card's
    # 3xTF32 forward against the f32 recompute, much magnified) gives the
    # same gradients: the statistics pass renormalises P
    off = torch.from_numpy(np.random.default_rng(4).uniform(
        -1e-3, 1e-3, lse.shape).astype(np.float32))
    for lse_in in (lse, torch.where(lse > NEG_INF, lse + off, lse)):
        got = _emulated_bwd(q, k, v, lse_in, do, **masks)
        for name, g, w in zip("qkv", got, want):
            _close(g.numpy(), w.numpy(), name)


def test_flash_attention_is_differentiable_on_the_cpu():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 8))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    want = fa_ops.flash_attention_bwd(q, k, v, None, do, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fa_ops.flash_attention_bwd.launches == 0
