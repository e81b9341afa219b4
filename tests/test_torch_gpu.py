"""Card-only tests of the PyTorch port (marker ``gpu``): each CUDA
kernel against its plain PyTorch version on the same CUDA tensors, and
the engine on the card against the engine on the CPU.

This module imports neither JAX nor the JAX package, so it runs on a
GPU host without them:  ``python -m pytest -m gpu tests/test_torch_*.py``.
Each test decides about the card in its body and skips without one.

TF32 is off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``): it flips near-tie argmins.
Tolerances: router heads rtol=atol=1e-5 and exact choices; attention
rtol=1e-5, atol=2e-5 (the kernel's online softmax sums in another
order than the plain full softmax, and its products run in 3xTF32,
which keeps f32 accuracy: tests/test_torch_tf32.py); mLSTM scan, also
3xTF32: each of h, C1, n1, m1 within 1e-4 of the reference's largest
magnitude (f32 sums over up to 1024 terms in another order, then h
divides by a running denominator);
the xLSTM on the card against the CPU: logits atol=rtol=1e-4 and the
same greedy tokens; ``serve()`` on the card against the CPU: the same
expert and depth per uid, NLL atol=rtol=1e-4.  Attention has a backward
kernel: dQ, dK and dV within 1e-4 of each gradient's largest magnitude
against torch autograd of the plain version, bit-identical on a rerun;
one expert training step on the card against the CPU: loss to rtol
1e-4, weights within 1e-4 of each leaf's largest magnitude.  It takes
bf16 and head_dim up to 256 too: bf16 gradients within one bf16 ulp of
the plain f32 gradient rounded, plus 1e-4 of the largest.  The mLSTM
scan has one as well: dq, dk, dv, di, df within 1e-4 of each gradient's
largest magnitude against autograd of the chunkwise plain version,
bit-identical on a rerun; and a bf16 ``train_step`` of a 2-layer
tinyllama and of a reduced xlstm on the card launches both backward
kernels and no plain version, with its loss falling.  The router heads
have none, so their wrappers refuse a CUDA input that requires grad
under grad mode.  The cache tiers on the card: ``_score_from_emb``
(one ``router_score`` launch) within 1e-6 of the plain head on the same
tensors, ``_embed_batch`` within 1e-5 of the CPU's largest magnitude,
and a ``DiskKVStore``-backed engine answers everything from T2 after a
restart.  Attention in bf16 and at head_dim up to 256: bf16 outputs
within one bf16 ulp of each element plus 2e-5 (the f32 tolerance before
both round), f32 at the f32 tolerances.  The zoo's reduced decoders
(dense, MoE and the Mamba hybrid) on the card against the CPU in f32:
logits, caches and Mamba states rtol=atol=1e-4, the same greedy tokens.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.core import objective
from repro_torch.core.library import ExpertSpec, ModelLibrary, _enc
from repro_torch.core.router import RouterConfig, init_router
from repro_torch.kernels import launches
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops
from repro_torch.data.batching import mlm_batch
from repro_torch.models.model import count_params, init_model
from repro_torch.serving import ExpertHealth, Request, TryageEngine

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


ATTN_CASES = [  # (S, H, KV, hd, causal, window, softcap)
    (128, 4, 4, 32, False, 0, 0.0),     # router layer
    (128, 4, 4, 40, False, 0, 0.0),     # d=160 specialists
    (128, 8, 8, 32, False, 0, 0.0),     # roberta-analog
    (128, 4, 2, 32, True, 0, 0.0),
    (32, 4, 1, 40, True, 8, 0.0),
    (128, 2, 2, 32, False, 16, 30.0),
    (128, 8, 8, 128, False, 0, 0.0),    # dynamic shared memory > 48 KB
    (77, 3, 1, 64, True, 20, 10.0),     # ragged tiles
]


@pytest.mark.parametrize("S,H,KV,hd,causal,window,softcap", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(S, H, KV, hd, causal, window,
                                              softcap):
    _card()
    g = torch.Generator(device="cuda").manual_seed(S * hd)
    q = torch.randn(3, S, H, hd, device="cuda", generator=g)
    k, v = (torch.randn(3, S, KV, hd, device="cuda", generator=g)
            for _ in range(2))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    ref = fa_ops.attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=2e-5)


ATTN_EDGES = [  # (B, S, T, H, KV, hd, causal, window, softcap)
    (1, 128, 128, 1, 1, 32, False, 0, 0.0),    # B*H = 1: one block
    (1, 128, 128, 4, 4, 32, False, 0, 0.0),    # batch 1 of the main path
    (2, 1, 1, 4, 4, 32, False, 0, 0.0),        # S = T = 1
    (2, 1, 70, 4, 2, 40, False, 0, 0.0),       # one query, ragged keys
    (2, 50, 50, 4, 4, 40, True, 0, 0.0),       # S not a multiple of 16
    (2, 40, 200, 4, 1, 40, False, 0, 0.0),     # T > S, GQA with KV = 1
    (2, 130, 64, 2, 2, 8, False, 0, 5.0),      # hd 8, T < S
    (1, 33, 150, 4, 4, 128, True, 32, 0.0),    # hd 128, T != S
]


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window,softcap", ATTN_EDGES)
def test_flash_attention_kernel_edges(B, S, T, H, KV, hd, causal, window,
                                      softcap):
    """The edges of the kernel's tiling: 16-row warp tiles, 1-4 warps a
    block, 64-key tiles, one template instance per hd / 8."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(B * S + T * hd)
    q = torch.randn(B, S, H, hd, device="cuda", generator=g)
    k, v = (torch.randn(B, T, KV, hd, device="cuda", generator=g)
            for _ in range(2))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    ref = fa_ops.attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=2e-5)


BF16_CASES = [  # (B, S, T, H, KV, hd, causal, window, softcap)
    (2, 128, 128, 32, 4, 64, True, 0, 0.0),     # tinyllama's heads
    (2, 96, 96, 16, 16, 64, True, 0, 0.0),      # qwen1.5-0.5b's
    (1, 200, 200, 8, 4, 256, True, 64, 0.0),    # gemma3 local, rolls
    (1, 200, 200, 8, 4, 256, True, 0, 0.0),     # gemma3 global
    (1, 300, 300, 48, 4, 128, True, 256, 0.0),  # starcoder2, past window
    (2, 64, 64, 16, 16, 80, False, 0, 0.0),     # hubert's
    (1, 130, 130, 8, 8, 128, False, 0, 0.0),
    (2, 77, 90, 4, 2, 136, False, 0, 30.0),     # odd hd / 8 above 128
    (1, 50, 50, 2, 1, 200, True, 0, 5.0),
    (1, 20, 8, 2, 2, 256, False, 3, 0.0),       # rows that see no key
    (1, 256, 256, 48, 8, 128, True, 0, 30.0),   # grok-1: GQA 48:8, softcap
]


def bf16_ulp(x):
    """One bf16 unit in the last place of each element of ``x``."""
    x = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window,softcap", BF16_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_kernel_bf16_and_wide_heads(B, S, T, H, KV, hd,
                                                    causal, window, softcap,
                                                    dtype):
    """bf16 inputs and head_dim up to 256 (two column halves above 128):
    bf16 within one bf16 ulp of each element plus the f32 tolerance (the
    kernel's f32 result is within 2e-5 of the plain version's before
    each rounds to bf16); f32 at the f32 tolerances."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(B * S + T * hd)
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, hd, device="cuda", generator=g).to(dt)
    k, v = (torch.randn(B, T, KV, hd, device="cuda", generator=g).to(dt)
            for _ in range(2))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    ref = fa_ops.attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    if dt == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=2e-5)
    else:
        err = (out.float() - ref.float()).abs()
        bound = bf16_ulp(torch.maximum(out.float().abs(), ref.float().abs()))
        assert bool((err <= bound + 2e-5).all()), float((err - bound).max())


def test_flash_attention_refuses_what_it_does_not_take_on_the_card():
    _card()
    x = torch.zeros(1, 4, 2, 264, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(x, x, x)
    h = torch.zeros(1, 4, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        fa_ops.flash_attention(h, h, h)
    # the backward takes bf16 and head_dim 256, and refuses an output
    # gradient of another type
    for dt, hd in ((torch.bfloat16, 64), (torch.float32, 256)):
        q = torch.zeros(1, 4, 2, hd, device="cuda", dtype=dt,
                        requires_grad=True)
        out = fa_ops.flash_attention(q, q, q)
        out.sum().backward()
        assert q.grad.dtype == dt and bool(torch.isfinite(q.grad).all())
        lse = fa_ops._forward(q.detach(), q.detach(), q.detach(), True, 0,
                              0.0, True)[1]
        with pytest.raises(ValueError, match="do not fit"):
            fa_ops.flash_attention_bwd(q.detach(), q.detach(), q.detach(),
                                       lse, q.detach().half())


def _head_case(B, M, tied, seed, d=128, hh=128, n_c=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    c = {"emb": f(B, d), "w1": f(d, hh) / 11, "b1": f(hh) / 5,
         "w2": f(hh, M) / 11, "b2": f(M) / 5, "uw1": f(d, hh) / 11,
         "ub1": f(hh) / 5, "uw2": f(hh, M) / 11, "ub2": f(M) / 5,
         "cvals": np.abs(f(n_c, M)), "lam": np.abs(f(B, n_c))}
    if tied:
        c["w2"][:] = c["w2"][:, :1]
        c["b2"][:] = 0.3
        c["lam"][:] = 0.0
    return {k: torch.from_numpy(v).cuda() for k, v in c.items()}


def _router_both(t, ladder, plain=False):
    """Both router heads on ``t``: kernels, or their plain versions."""
    s_args = [t[k] for k in ("emb", "w1", "b1", "w2", "b2", "cvals", "lam")]
    c_args = [t[k] for k in ("emb", "w1", "b1", "w2", "b2", "uw1", "ub1",
                             "uw2", "ub2", "cvals", "lam")] + [ladder]
    if plain:
        return (rs_ops.router_score_plain(*s_args)
                + rc_ops.router_cascade_plain(*c_args))
    before = (rs_ops.router_score_fused.launches,
              rc_ops.router_score_cascade_fused.launches)
    out = (rs_ops.router_score_fused(*s_args)
           + rc_ops.router_score_cascade_fused(*c_args))
    torch.cuda.synchronize()
    assert (rs_ops.router_score_fused.launches,
            rc_ops.router_score_cascade_fused.launches) == (before[0] + 1,
                                                            before[1] + 1)
    return out


def _ladder(M):
    return torch.from_numpy(
        np.random.default_rng(1).permutation(M).astype(np.int32)).cuda()


PATH_WIDTH = (128, 128, 11, 2)    # (d, hh, M, n_c) of the main path
ROUTER_CASES = (                  # (B, d, hh, M, n_c)
    [(B,) + PATH_WIDTH for B in (1, 2, 4, 8, 16, 32, 64, 3, 37)]
    + [(37, 128, 128, 1, 2),      # one expert
       (37, 128, 128, 33, 2),     # more experts than lanes of a warp
       (37, 128, 96, 11, 2),      # hh not a power of two
       (37, 80, 128, 11, 2),      # d not a power of two
       (37, 128, 128, 11, 4)])    # four constraints


@pytest.mark.parametrize("B,d,hh,M,n_c", ROUTER_CASES)
@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_router_kernels_match_plain(B, d, hh, M, n_c, tied):
    """Every bucket size of the path and the edges of the kernels'
    geometry; ``tied`` makes every expert tie (the first index and the
    earliest rung must win, exactly as in the plain versions)."""
    _card()
    t = _head_case(B, M, tied, seed=B + M, d=d, hh=hh, n_c=n_c)
    got = _router_both(t, _ladder(M))
    want = _router_both(t, _ladder(M), plain=True)
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_router_kernels_pad_rows_leave_real_rows():
    """Rows appended with zero lambdas (the engine's bucket padding)
    leave the real rows' outputs bit for bit as they were."""
    _card()
    M = 11
    t = _head_case(5, M, False, seed=5)
    g = torch.Generator(device="cuda").manual_seed(0)
    padded = dict(t)
    padded["emb"] = torch.cat([t["emb"], torch.randn(
        11, 128, device="cuda", generator=g) * 9])
    padded["lam"] = torch.cat([t["lam"], torch.zeros(11, 2, device="cuda")])
    alone = _router_both(t, _ladder(M))
    more = _router_both(padded, _ladder(M))
    for a, b in zip(alone, more):
        assert torch.equal(a, b[:5])


def _library(device):
    specs = [ExpertSpec("small", _enc("small", 1, 32, 2, 64, 64), {}, 0.5),
             ExpertSpec("mid", _enc("mid", 1, 48, 2, 96, 64), {}, 0.5),
             ExpertSpec("big", _enc("big", 2, 80, 2, 160, 64), {}, 0.9)]
    for i, e in enumerate(specs):
        e.params = init_model(e.cfg, seed=i, device=device)
        e.n_params = count_params(e.params)
    return ModelLibrary(specs)


def test_engine_on_card_matches_cpu():
    """A mixed-flag, mixed-threshold workload (one batch without cascade
    traffic, so both router kernels run) through the kernels on the
    card and through the plain versions on the CPU."""
    _card()
    rc = RouterConfig(n_models=3, vocab_size=64, num_layers=1, d_model=32,
                      num_heads=2, d_ff=64)
    lib_cpu = _library("cpu")
    router_cpu = init_router(rc, seed=9, uncertainty=True, device="cpu")
    lib_gpu = copy.deepcopy(lib_cpu)
    for e in lib_gpu.experts:
        e.params.cuda()
    router_gpu = copy.deepcopy(router_cpu).cuda()
    rng = np.random.default_rng(0)
    mb = mlm_batch(rng.integers(4, 64, size=(96, 32)).astype(np.int32), rng,
                   0.2, 64)
    mix = [{}, {"size": 1.0}, {"size": 8.0}, {"recency": 2.0}]
    thr = [0.55, 0.6, 0.65, 0.99]
    out = []
    for lib, router, dev in ((lib_cpu, router_cpu, "cpu"),
                             (lib_gpu, router_gpu, "cuda")):
        eng = TryageEngine(lib, router, rc,
                           [objective.size_constraint(lib),
                            objective.recency_constraint(lib)],
                           max_batch=32, fused_cascade=True, device=dev)
        for i in range(96):
            eng.submit(Request(uid=i, tokens=mb["tokens"][i],
                               targets=mb["targets"][i], mask=mb["mask"][i],
                               lambdas=mix[i % 4],
                               min_confidence=thr[i % 4] if i >= 32 else 0.0))
        launches.reset_launch_counts()
        out.append({r.uid: r for r in eng.run()})
        counts = launches.launch_counts()
    assert all(counts[n] > 0 for n in ("router_score", "router_cascade",
                                       "flash_attention")), counts
    cpu, gpu = out
    for uid, r in cpu.items():
        assert (gpu[uid].expert, gpu[uid].cascade_depth) == (
            r.expert, r.cascade_depth), uid
        np.testing.assert_allclose(gpu[uid].loss, r.loss, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(gpu[uid].pred_losses, r.pred_losses,
                                   rtol=1e-5, atol=1e-5)


MLSTM_CASES = [  # (B, S, H, dh, carried state)
    (2, 96, 2, 64, True),
    (1, 512, 2, 64, False),
    (1, 96, 1, 1024, True),
    (2, 512, 1, 1024, False),
    (1, 97, 1, 40, True),      # prime S: chunks of 1; ragged column tile
    (1, 128, 2, 32, True),     # one 32-column block
    (2, 64, 1, 40, True),      # one chunk; ragged 32-column block
    (1, 64, 3, 64, False),     # one chunk
    (1, 192, 1, 1024, True),   # B*H = 1 at the serving width
    (2, 97, 2, 64, True),      # prime S: chunks of 1
]


@pytest.mark.parametrize("B,S,H,dh,carried", MLSTM_CASES)
def test_mlstm_scan_kernel_matches_plain(B, S, H, dh, carried):
    _card()
    g = torch.Generator(device="cuda").manual_seed(S * dh)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    q, k, v = r(B, S, H, dh), r(B, S, H, dh), r(B, S, H, dh)
    i_pre, f_pre = r(B, S, H), r(B, S, H) + 3.0
    if carried:
        state = {"C": r(B, H, dh, dh) * 0.3, "n": r(B, H, dh) * 0.3,
                 "m": r(B, H)}
    else:
        state = {"C": torch.zeros(B, H, dh, dh, device="cuda"),
                 "n": torch.zeros(B, H, dh, device="cuda"),
                 "m": torch.zeros(B, H, device="cuda")}
    args = (q, k, v, i_pre, f_pre, state)
    before = ml_ops.mlstm_chunkwise.launches
    h, new = ml_ops.mlstm_chunkwise(*args)
    torch.cuda.synchronize()
    assert ml_ops.mlstm_chunkwise.launches == before + 1
    for ref_h, ref in (ml_ops.mlstm_chunkwise_plain(*args),
                       ml_ops.mlstm_sequential(*args)):
        for got, want in ((h, ref_h), (new["C"], ref["C"]),
                          (new["n"], ref["n"]), (new["m"], ref["m"])):
            assert torch.isfinite(got).all()
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-4 * scale


def test_xlstm_on_card_matches_cpu():
    """The reduced xLSTM: prefill through the mLSTM kernel and greedy
    decode on the card against the plain versions on the CPU."""
    _card()
    cfg = get_config("xlstm-1.3b").reduced(d_model=128)
    cpu = init_model(cfg, seed=3, device="cpu")
    gpu = copy.deepcopy(cpu).cuda()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32))
    out = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        launches.reset_launch_counts()
        last, st = prefill_step(model, {"tokens": toks}, device=dev)
        n_prefill = launches.launch_counts()["mlstm_scan"]
        tok = last.argmax(-1).to(torch.int32)[:, None]
        got = [tok]
        for t in range(6):
            tok, st = serve_step(model, st, tok, 96 + t, device=dev)
            got.append(tok)
        out.append((last.cpu(), torch.cat(got, 1).cpu(), n_prefill,
                    launches.launch_counts()["mlstm_scan"] - n_prefill))
    (lc, tc, pc, dc), (lg, tg, pg, dg) = out
    assert (pc, dc) == (0, 0)
    assert (pg, dg) == (cfg.layer_pattern.count("mlstm"), 0)
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    assert torch.equal(tg, tc)


ZOO_CARD = [("tinyllama-1.1b", None, False), ("gemma3-4b", 8, False),
            ("qwen2-vl-72b", None, True), ("starcoder2-15b", 8, False),
            ("qwen2-moe-a2.7b", None, False), ("jamba-v0.1-52b", None, False)]


@pytest.mark.parametrize("arch,window,embeds", ZOO_CARD)
def test_zoo_decoder_on_card_matches_cpu(arch, window, embeds):
    """A reduced decoder (f32, d 128): prefill into the KV cache (and
    jamba's Mamba states) through the attention kernel and 6 greedy
    decode steps on the card against the plain versions on the CPU, with
    the window configs' rings rolled (window 8, prompt 40); the MoE
    layers route on each side.  One attention launch per attention layer
    in the prefill, none in decode (XLA-style plain decode, as in the
    JAX package)."""
    import dataclasses
    _card()
    cfg = get_config(arch).reduced(d_model=128)
    if window:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, sliding_window=window))
    cpu = init_model(cfg, seed=3, device="cpu")
    gpu = copy.deepcopy(cpu).cuda()
    S, steps = 40, 6
    rng = np.random.default_rng(0)
    batch = ({"embeds": rng.normal(size=(2, S, cfg.d_model)).astype(
        np.float32)} if embeds else {"tokens": rng.integers(
            0, cfg.vocab_size, (2, S)).astype(np.int32)})
    out = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        launches.reset_launch_counts()
        last, st = prefill_step(model, batch, cache_capacity=S + steps,
                                device=dev)
        n_prefill = launches.launch_counts()["flash_attention"]
        tok = last.argmax(-1).to(torch.int32)[:, None]
        got = [tok]
        for t in range(steps):
            tok, st = serve_step(model, st, tok, S + t, device=dev)
            got.append(tok)
        out.append((last.cpu(), torch.cat(got, 1).cpu(), n_prefill,
                    launches.launch_counts()["flash_attention"] - n_prefill,
                    [{n: a.cpu() for n, a in x.items()} for x in st]))
    (lc, tc, pc, dc, sc), (lg, tg, pg, dg, sg) = out
    assert (pc, dc) == (0, 0)
    n_attn = sum(cfg.layer_pattern[i % len(cfg.layer_pattern)] == "attn"
                 for i in range(cfg.num_layers))
    assert (pg, dg) == (n_attn, 0)
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    assert torch.equal(tg, tc)
    for a, b in zip(sg, sc):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_zoo_decoder_bf16_on_card():
    """tinyllama reduced in its own type (bf16): the prefill goes through
    the bf16 kernel (one launch a layer) into bf16 caches, and greedy
    decode runs from them without a launch.  (Against the CPU it is
    held in f32 above: in bf16 the two sides round at other places.)"""
    import dataclasses
    _card()
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(
        d_model=256), dtype="bfloat16")
    model = init_model(cfg, seed=5, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)).cuda()
    launches.reset_launch_counts()
    last, st = prefill_step(model, {"tokens": toks}, cache_capacity=68)
    assert launches.launch_counts()["flash_attention"] == cfg.num_layers
    assert all(x["k"].dtype == torch.bfloat16 and x["k"].shape[1] == 68
               for x in st)
    assert bool(torch.isfinite(last).all())
    tok = last.argmax(-1).to(torch.int32)[:, None]
    for t in range(4):
        tok, st = serve_step(model, st, tok, 64 + t)
        assert bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    assert launches.launch_counts()["flash_attention"] == cfg.num_layers


def _grad_cases():
    """(name, wrapper call on CUDA tensors whose first input requires
    grad when ``grad`` is set)."""
    def attention(grad):
        q, k, v = (torch.randn(1, 16, 2, 32, device="cuda")
                   for _ in range(3))
        return fa_ops.flash_attention(q.requires_grad_(grad), k, v,
                                      causal=False)

    def mlstm(grad):
        r = lambda *s: torch.randn(*s, device="cuda")
        state = {"C": r(1, 1, 8, 8), "n": r(1, 1, 8), "m": r(1, 1)}
        return ml_ops.mlstm_chunkwise(r(1, 16, 1, 8).requires_grad_(grad),
                                      r(1, 16, 1, 8), r(1, 16, 1, 8),
                                      r(1, 16, 1), r(1, 16, 1), state)

    def score(grad):
        t = _head_case(2, 11, False, seed=0)
        t["w1"].requires_grad_(grad)
        return rs_ops.router_score_fused(*(t[k] for k in (
            "emb", "w1", "b1", "w2", "b2", "cvals", "lam")))

    def cascade(grad):
        t = _head_case(2, 11, False, seed=0)
        t["emb"].requires_grad_(grad)
        return rc_ops.router_score_cascade_fused(*(t[k] for k in (
            "emb", "w1", "b1", "w2", "b2", "uw1", "ub1", "uw2", "ub2",
            "cvals", "lam")), _ladder(11))

    return {"flash_attention": attention, "mlstm_chunkwise": mlstm,
            "router_score": score, "router_cascade": cascade}


@pytest.mark.parametrize("name", ["flash_attention", "mlstm_chunkwise",
                                  "router_score", "router_cascade"])
def test_wrappers_refuse_grad_on_the_card(name):
    """Attention and the mLSTM scan have backward kernels: their outputs
    carry a gradient, computed by those kernels (held to the plain
    versions by ``test_flash_attention_backward_matches_plain`` and
    ``test_mlstm_backward_matches_plain``).  The router heads, under
    grad mode with a CUDA input that requires grad, raise instead of
    silently dropping the gradient; under ``no_grad`` (and with no such
    input) every kernel launches."""
    _card()
    call = _grad_cases()[name]
    if name in ("flash_attention", "mlstm_chunkwise"):
        out = call(True)
        out = out[0] if isinstance(out, tuple) else out
        assert out.grad_fn is not None
        bwd = (fa_ops.flash_attention_bwd if name == "flash_attention"
               else ml_ops.mlstm_chunkwise_bwd)
        before = bwd.launches
        out.sum().backward()
        assert bwd.launches == before + 1
    else:
        with pytest.raises(RuntimeError, match="no backward"):
            call(True)
    with torch.no_grad():
        call(True)
    call(False)
    torch.cuda.synchronize()


BWD_CASES = [  # (B, S, T, H, KV, hd, causal, window, softcap)
    (16, 128, 128, 8, 8, 32, False, 0, 0.0),   # roberta-analog
    (16, 128, 128, 4, 4, 40, False, 0, 0.0),   # d=160 specialists
    (32, 128, 128, 4, 4, 32, False, 0, 0.0),   # router, adaptation
    (2, 77, 77, 4, 2, 16, True, 0, 0.0),
    (2, 50, 50, 4, 4, 24, True, 9, 0.0),
    (2, 64, 64, 6, 2, 32, False, 0, 5.0),
    (1, 40, 40, 2, 1, 128, True, 7, 3.0),
    (1, 20, 8, 2, 2, 8, False, 3, 0.0),        # rows with no key
    # one launch up to 128 keys, two launches past it
    (2, 96, 128, 4, 2, 40, False, 0, 0.0),
    (2, 96, 129, 4, 2, 40, False, 0, 2.0),
    (2, 128, 128, 4, 4, 128, False, 0, 0.0),   # hd 128, one launch
    (1, 300, 300, 2, 1, 64, True, 64, 0.0),    # long T, causal window
    (1, 300, 140, 2, 2, 8, False, 3, 0.0),     # long T, rows with no key
]


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window,softcap", BWD_CASES)
def test_flash_attention_backward_matches_plain(B, S, T, H, KV, hd, causal,
                                                window, softcap):
    _card()
    g = torch.Generator(device="cuda").manual_seed(S * hd)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    q, k, v, do = r(B, S, H, hd), r(B, T, KV, hd), r(B, T, KV, hd), \
        r(B, S, H, hd)
    masks = dict(causal=causal, window=window, softcap=softcap)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa_ops.flash_attention(*leaves, **masks),
                              leaves, do)
    again = torch.autograd.grad(fa_ops.flash_attention(*leaves, **masks),
                                leaves, do)
    want = fa_ops.attention_grad_plain(q, k, v, do, **masks)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())


BF16_BWD_CASES = [  # (B, S, T, H, KV, hd, causal, window, softcap)
    (2, 77, 77, 4, 2, 16, True, 0, 0.0),
    (2, 96, 129, 4, 2, 40, False, 0, 2.0),
    (2, 60, 60, 2, 2, 128, False, 0, 0.0),     # hd 128, one launch
    (1, 130, 130, 2, 2, 256, True, 64, 0.0),   # hd 256: 64-key blocks
    (2, 64, 64, 4, 2, 136, False, 0, 2.0),     # odd hd / 8: halves overlap
    (1, 90, 90, 2, 1, 248, False, 20, 1.0),
    (2, 512, 512, 8, 2, 64, True, 0, 0.0),
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window,softcap",
                         BF16_BWD_CASES)
def test_flash_attention_backward_bf16_and_wide_heads(B, S, T, H, KV, hd,
                                                      causal, window,
                                                      softcap, dtype):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(S + hd)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g).to(dt)
    q, k, v, do = r(B, S, H, hd), r(B, T, KV, hd), r(B, T, KV, hd), \
        r(B, S, H, hd)
    masks = dict(causal=causal, window=window, softcap=softcap)
    lse = fa_ops._forward(q, k, v, causal, window, softcap, True)[1]
    got = fa_ops.flash_attention_bwd(q, k, v, lse, do, **masks)
    again = fa_ops.flash_attention_bwd(q, k, v, lse, do, **masks)
    want = fa_ops.attention_grad_plain(q.float(), k.float(), v.float(),
                                       do.float(), **masks)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.dtype == dt and torch.equal(a, b)
        err, scale = (a.float() - w).abs(), float(w.abs().max())
        if dt == torch.float32:
            assert float(err.max()) <= 1e-4 * scale
        else:
            bound = bf16_ulp(w.bfloat16().float().abs()) + 1e-4 * scale
            assert bool((err <= bound).all()), float((err - bound).max())


def _mlstm_inputs(B, S, H, dh, carried, seed):
    """q, k, v, i, f and a state for the scan on the card: forget gates
    biased by +3 as the model's are; a carried state small and random,
    else zeros."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    q, k, v = r(B, S, H, dh), r(B, S, H, dh), r(B, S, H, dh)
    i_pre, f_pre = r(B, S, H), r(B, S, H) + 3.0
    if carried:
        state = {"C": r(B, H, dh, dh) * 0.3, "n": r(B, H, dh) * 0.3,
                 "m": r(B, H)}
    else:
        state = {"C": torch.zeros(B, H, dh, dh, device="cuda"),
                 "n": torch.zeros(B, H, dh, device="cuda"),
                 "m": torch.zeros(B, H, device="cuda")}
    return q, k, v, i_pre, f_pre, state


MLSTM_BWD_CASES = [  # (B, S, H, dh, carried state)
    (1, 40, 3, 16, False), (2, 128, 2, 64, False), (2, 96, 2, 32, True),
    (2, 128, 2, 256, False), (2, 512, 4, 1024, False)]


@pytest.mark.parametrize("B,S,H,dh,carried", MLSTM_BWD_CASES)
def test_mlstm_backward_matches_plain(B, S, H, dh, carried):
    _card()
    q, k, v, i, f, st = _mlstm_inputs(B, S, H, dh, carried, seed=dh)
    dh_ = torch.randn(B, S, H, dh, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, i, f)]
    h, _ = ml_ops.mlstm_chunkwise(*leaves, st)
    got = torch.autograd.grad(h, leaves, dh_)
    h, _ = ml_ops.mlstm_chunkwise(*leaves, st)
    again = torch.autograd.grad(h, leaves, dh_)
    want = ml_ops.mlstm_chunkwise_grad_plain(q, k, v, i, f, st, dh_)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.parametrize("arch,cut", [("tinyllama-1.1b", {"num_layers": 2}),
                                      ("xlstm-1.3b", None)])
def test_bf16_train_step_on_card(arch, cut):
    """A bf16 training step runs both backward kernels where the model
    has their layers, no plain version, and the loss falls on a fixed
    batch."""
    import dataclasses
    from repro_torch.launch.steps import train_step
    from repro_torch.optim import adamw_init
    _card()
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, **cut) if cut else dataclasses.replace(
        cfg.reduced(), dtype="bfloat16")
    model = init_model(cfg, seed=0, device="cuda")
    opt = adamw_init(model)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 128),
                                     device="cuda", generator=g)}
    plain = {n: getattr(mod, n) for mod, n in (
        (fa_ops, "attention_plain"), (fa_ops, "attention_grad_plain"),
        (ml_ops, "mlstm_chunkwise_plain"),
        (ml_ops, "mlstm_chunkwise_grad_plain"))}
    try:
        for mod, n in ((fa_ops, "attention_plain"),
                       (fa_ops, "attention_grad_plain"),
                       (ml_ops, "mlstm_chunkwise_plain"),
                       (ml_ops, "mlstm_chunkwise_grad_plain")):
            setattr(mod, n, lambda *a, n=n, **k: pytest.fail(f"{n} ran"))
        launches.reset_launch_counts()
        losses = [float(train_step(model, opt, batch, lr=1e-3))
                  for _ in range(3)]
    finally:
        for n, fn in plain.items():
            setattr(fa_ops if "attention" in n else ml_ops, n, fn)
    counts = launches.launch_counts()
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    pat = cfg.layer_pattern
    kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
    assert counts["flash_attention_bwd"] == 3 * kinds.count("attn")
    assert counts["mlstm_scan_bwd"] == 3 * kinds.count("mlstm")


def test_flash_attention_backward_takes_strided_inputs():
    """Inputs the kernel cannot read as they are (a transposed view, a
    row offset that breaks 16-byte alignment) are copied first; the
    gradients are those of contiguous inputs."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(5)
    B, S, H, hd = 2, 40, 4, 16
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    q, k, v, do = (r(B, H, S, hd).transpose(1, 2) for _ in range(4))
    lse = fa_ops._forward(q.contiguous(), k.contiguous(), v.contiguous(),
                          True, 0, 0.0, True)[1]
    shifted = torch.empty(lse.numel() + 1, device="cuda")[1:].view_as(lse)
    shifted.copy_(lse)
    got = fa_ops.flash_attention_bwd(q, k, v, shifted, do, causal=True)
    want = fa_ops.flash_attention_bwd(*(t.contiguous() for t in (q, k, v)),
                                      lse, do.contiguous(), causal=True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_expert_step_on_card_matches_cpu():
    """One training step of an expert (forward, MLM loss, backward
    through both attention kernels, AdamW) on the card and on the CPU
    from the same weights and batch."""
    _card()
    from repro_torch.core.training import expert_step, to_device
    from repro_torch.optim import adamw_init
    cfg = _enc("t", 2, 64, 2, 128, 64)
    cpu = init_model(cfg, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(0)
    batch = mlm_batch(rng.integers(4, 64, size=(8, 32)).astype(np.int32),
                      rng, 0.2, 64)
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        _, loss = expert_step(model, adamw_init(model), to_device(batch, dev),
                              lr=1e-3)
        losses.append(float(loss))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    for (n, a), (_, b) in zip(cpu.named_parameters(), gpu.named_parameters()):
        err = float((b.detach().cpu() - a.detach()).abs().max())
        assert err <= 1e-4 * float(a.detach().abs().max()), n


def test_serve_on_card_matches_cpu():
    """``serve()`` on the card against the same engine on the CPU: the
    mixed workload with cascade floors, deadline flushes and a health
    tracker with an expert forced down, through all three kernels."""
    _card()
    rc = RouterConfig(n_models=3, vocab_size=64, num_layers=1, d_model=32,
                      num_heads=2, d_ff=64)
    lib_cpu = _library("cpu")
    router_cpu = init_router(rc, seed=9, uncertainty=True, device="cpu")
    lib_gpu = copy.deepcopy(lib_cpu)
    for e in lib_gpu.experts:
        e.params.cuda()
    router_gpu = copy.deepcopy(router_cpu).cuda()
    rng = np.random.default_rng(0)
    mb = mlm_batch(rng.integers(4, 64, size=(96, 32)).astype(np.int32), rng,
                   0.2, 64)
    mix = [{}, {"size": 1.0}, {"size": 8.0}, {"recency": 2.0}]
    thr = [0.55, 0.6, 0.65, 0.99]
    out = []
    for lib, router, dev in ((lib_cpu, router_cpu, "cpu"),
                             (lib_gpu, router_gpu, "cuda")):
        clock = [1.0]
        health = ExpertHealth(3, now_fn=lambda: clock[0])
        health.force_down(1)
        eng = TryageEngine(lib, router, rc,
                           [objective.size_constraint(lib),
                            objective.recency_constraint(lib)],
                           max_batch=16, max_wait_s=0.05, fused_cascade=True,
                           health=health, now_fn=lambda: clock[0],
                           device=dev)

        def arrivals():
            for i in range(96):
                yield Request(uid=i, tokens=mb["tokens"][i],
                              targets=mb["targets"][i], mask=mb["mask"][i],
                              lambdas=mix[i % 4],
                              min_confidence=thr[i % 4] if i >= 32 else 0.0)
                clock[0] += 0.01

        launches.reset_launch_counts()
        out.append({r.uid: r for r in eng.serve(arrivals())})
        counts = launches.launch_counts()
        flushes = dict(eng.stats.flushes)
    assert all(counts[n] > 0 for n in ("router_score", "router_cascade",
                                       "flash_attention")), counts
    assert flushes.get("deadline", 0) > 0, flushes
    cpu, gpu = out
    assert sorted(gpu) == sorted(cpu) == list(range(96))
    for uid, r in cpu.items():
        assert (gpu[uid].expert, gpu[uid].cascade_depth,
                gpu[uid].fallback_depth) == (
            r.expert, r.cascade_depth, r.fallback_depth), uid
        assert r.expert != "mid"
        np.testing.assert_allclose(gpu[uid].loss, r.loss, rtol=1e-4,
                                   atol=1e-4)


def _tiny_engines(tmp_dir=None):
    """The card engine over ``_library`` and a router with an
    uncertainty head, and the same weights on the CPU."""
    rc = RouterConfig(n_models=3, vocab_size=64, num_layers=1, d_model=32,
                      num_heads=2, d_ff=64)
    lib_cpu = _library("cpu")
    router_cpu = init_router(rc, seed=9, uncertainty=True, device="cpu")
    lib_gpu = copy.deepcopy(lib_cpu)
    for e in lib_gpu.experts:
        e.params.cuda()
    router_gpu = copy.deepcopy(router_cpu).cuda()
    out = []
    for lib, router, dev in ((lib_cpu, router_cpu, "cpu"),
                             (lib_gpu, router_gpu, "cuda")):
        out.append(TryageEngine(lib, router, rc,
                                [objective.size_constraint(lib),
                                 objective.recency_constraint(lib)],
                                max_batch=32, device=dev))
    return out


def _tiny_requests(n, seed=0):
    rng = np.random.default_rng(seed)
    mb = mlm_batch(rng.integers(4, 64, size=(n, 32)).astype(np.int32), rng,
                   0.2, 64)
    mix = [{}, {"size": 1.0}, {"size": 8.0}, {"recency": 2.0}]
    return [Request(uid=i, tokens=mb["tokens"][i], targets=mb["targets"][i],
                    mask=mb["mask"][i], lambdas=mix[i % 4])
            for i in range(n)]


def test_score_from_emb_on_card_launches_router_score():
    """The semantic tier's scoring from embeddings: one ``router_score``
    launch (zero constraints) for the predicted losses, within 1e-6 of
    the plain head on the same CUDA tensors, and the host f64 argmin."""
    _card()
    _, eng = _tiny_engines()
    reqs = _tiny_requests(13)
    g = torch.Generator(device="cuda").manual_seed(5)
    emb = torch.randn(13, 32, device="cuda", generator=g)
    before = rs_ops.router_score_fused.launches
    pred, choice = eng._score_from_emb(reqs, emb.cpu().numpy())
    assert rs_ops.router_score_fused.launches == before + 1
    head = eng.router_params.head
    with torch.no_grad():
        want = rs_ops.head_plain(emb, head["w1"], head["b1"], head["w2"],
                                 head["b2"]).cpu().numpy()
    np.testing.assert_allclose(pred, want, rtol=0, atol=1e-6)
    scores = pred.astype(np.float64)
    for c in eng.constraints:
        lam = np.array([r.lambdas.get(c.name, 0.0) for r in reqs])
        scores = scores + lam[:, None] * c.values[None, :]
    np.testing.assert_array_equal(choice, scores.argmin(1))


def test_embed_batch_on_card_matches_cpu():
    _card()
    cpu, gpu = _tiny_engines()
    reqs = _tiny_requests(21)
    a, b = cpu._embed_batch(reqs), gpu._embed_batch(reqs)
    assert a.shape == b.shape == (21, 32) and b.dtype == np.float32
    assert np.abs(b - a).max() <= 1e-5 * np.abs(a).max()


def test_disk_tier_on_card_survives_a_restart(tmp_path):
    """A ``DiskKVStore``-backed card engine, with the semantic tier on,
    serves the same traffic again after a restart entirely from the
    exact tiers (T2)."""
    _card()
    _, eng = _tiny_engines()
    lib, router, rc = eng.library, eng.router_params, eng.rc
    cons = [objective.size_constraint(lib), objective.recency_constraint(lib)]
    first = {}
    for run in range(2):
        eng = TryageEngine(lib, router, rc, cons, max_batch=32,
                           cache_dir=str(tmp_path), cache_semantic_eps=1e-3,
                           device="cuda")
        launches.reset_launch_counts()
        for r in _tiny_requests(48):
            eng.submit(r)
        out = {r.uid: r for r in eng.run()}
        eng.cache.close()
        if run == 0:
            first = out
            assert launches.launch_counts()["router_score"] > 0
            continue
        assert eng.stats.cache_hit_rate == 1.0
        assert dict(eng.stats.cache_tier_hits) == {"t2": 48}
        assert eng.stats.router_batches == 0
        for uid, r in out.items():
            assert r.expert == first[uid].expert
            np.testing.assert_array_equal(r.pred_losses,
                                          first[uid].pred_losses)
