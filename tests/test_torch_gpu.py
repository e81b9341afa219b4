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
expert and depth per uid, NLL atol=rtol=1e-4.  No kernel has a backward
yet, so each wrapper refuses a CUDA input that requires grad under
grad mode.
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
    """No kernel has a backward: under grad mode a CUDA input that
    requires grad raises instead of silently dropping the gradient;
    under ``no_grad`` (and with no such input) the kernel launches."""
    _card()
    call = _grad_cases()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    with torch.no_grad():
        call(True)
    call(False)
    torch.cuda.synchronize()


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
