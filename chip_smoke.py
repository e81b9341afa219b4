#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the main path's shapes,
serves 256 requests through ``TryageEngine.run()`` over the paper-scale
library (11 experts, vocab 512, seeded random weights) with the router's
uncertainty head and the fused cascade on, checks that every kernel of
the path was launched in that run and that the answers match a CPU run
of the same engine, and times each kernel beside its bound.  Each phase
prints one JSON line; the line before the last is the card's name and
power limit from ``nvidia-smi``, the last is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result.  Without a CUDA card, or
outside a checkout, it exits non-zero at once.

TF32 is off throughout (it flips near-tie argmins).  Times: CUDA events
over back-to-back calls after a warm-up, and the profiler's device time
per kernel.  Bounds: the larger of the bytes each call must move over
3.35 TB/s and its f32 operations over 67 TFLOP/s (H100 SXM data sheet).
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
CHOICE_GAP = 1e-5          # a choice may differ only below this top-two gap
ROUTER_TOL = 1e-5          # router heads: pred / sigma vs the plain version
ATTN_TOL = 2e-5            # attention: online vs full softmax summation order
NLL_ATOL = 1e-4            # card vs CPU engine, per-request masked NLL

# the README's flag phrases; 192 unique prompts repeat with the same flags
FLAG_TEXTS = ["", "[Flag: Prefer small]", "[Flag: Smallest model]",
              "[Flag: Newest model]", "[Flag: Best model]",
              "[Flag: Small model] [Flag: Recent model]"]
N_REQUESTS, N_UNIQUE, SEQ, MAX_BATCH = 256, 192, 128, 32

SOURCES = {
    "router_score": ("src/repro_torch/kernels/csrc/router_score.cu",
                     "src/repro/kernels/router_score/kernel.py:24",
                     "router_score_kernel"),
    "router_cascade": ("src/repro_torch/kernels/csrc/router_cascade.cu",
                       "src/repro/kernels/router_cascade/kernel.py:48",
                       "router_cascade_kernel"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:25",
                        "flash_attention_kernel"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------ phase 1-2

def device_phase(torch) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32}}
    emit("device", **info)
    return info


def build_phase() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.library()
    ptxas = build.ptxas_summary(lib.ptxas_log)
    for name, (_, _, entry) in SOURCES.items():
        check(entry in ptxas, f"ptxas reported nothing for {entry}")
    emit("build", library=str(lib.path.relative_to(ROOT)),
         nvcc_seconds=lib.build_seconds,
         load_seconds=time.perf_counter() - t0,
         kernels={name: ptxas[entry]
                  for name, (_, _, entry) in SOURCES.items()})


# -------------------------------------------------------------- phase 3

def head_inputs(torch, B, M=11, d=128, hh=128, n_c=2, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda",
                                          generator=g) * scale
    t = {"emb": r(B, d), "w1": r(d, hh, scale=d ** -0.5),
         "b1": r(hh, scale=0.1), "w2": r(hh, M, scale=hh ** -0.5),
         "b2": r(M, scale=0.1), "uw1": r(d, hh, scale=d ** -0.5),
         "ub1": r(hh, scale=0.1), "uw2": r(hh, M, scale=hh ** -0.5),
         "ub2": r(M, scale=0.1), "cvals": r(n_c, M).abs(),
         "lam": r(B, n_c).abs()}
    t["ladder"] = torch.randperm(M, device="cuda", generator=g).to(
        torch.int32)
    return t


SCORE_ARGS = ("emb", "w1", "b1", "w2", "b2", "cvals", "lam")
CASCADE_ARGS = ("emb", "w1", "b1", "w2", "b2", "uw1", "ub1", "uw2", "ub2",
                "cvals", "lam", "ladder")


def choice_diffs(torch, got, want, combined):
    """(rows whose choice differs, of those the rows whose top-two gap
    of the constrained score is under CHOICE_GAP)."""
    diff = (got != want).nonzero().flatten()
    top2 = combined.topk(2, dim=1, largest=False).values
    near = (top2[:, 1] - top2[:, 0] < CHOICE_GAP)
    return int(diff.numel()), int(near[diff].sum())


def parity_phase(torch) -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.router_cascade import ops as rc_ops
    from repro_torch.kernels.router_score import ops as rs_ops
    err = {name: 0.0 for name in SOURCES}
    cases = []
    for B in (1, 3, 32, 37):
        t = head_inputs(torch, B, seed=B)
        pred, choice = rs_ops.router_score_fused(*(t[k] for k in SCORE_ARGS))
        cpred, sigma, cchoice, esc = rc_ops.router_score_cascade_fused(
            *(t[k] for k in CASCADE_ARGS))
        torch.cuda.synchronize()
        ppred, pchoice = rs_ops.router_score_plain(*(t[k] for k in SCORE_ARGS))
        qpred, qsigma, qchoice, qesc = rc_ops.router_cascade_plain(
            *(t[k] for k in CASCADE_ARGS))
        combined = ppred + t["lam"] @ t["cvals"]
        e_s = float((pred - ppred).abs().max())
        e_c = max(float((cpred - qpred).abs().max()),
                  float((sigma - qsigma).abs().max()))
        d_s, n_s = choice_diffs(torch, choice, pchoice, combined)
        d_c, n_c = choice_diffs(torch, cchoice, qchoice, combined)
        # an escalation target may differ only between near-tied experts
        rows = ((esc != qesc) & (cchoice == qchoice)).nonzero().flatten()
        gap = (combined[rows, esc[rows].long()]
               - combined[rows, qesc[rows].long()]).abs()
        d_e, n_e = int(rows.numel()), int((gap < CHOICE_GAP).sum())
        check(e_s <= ROUTER_TOL and e_c <= ROUTER_TOL,
              f"router heads at B={B}: max abs err {e_s}, {e_c}")
        check(d_s == n_s and d_c == n_c and d_e == n_e,
              f"router choices at B={B}: {d_s}/{d_c} differ, {n_s}/{n_c} "
              f"near ties; {d_e} escalation targets differ, {n_e} near ties")
        err["router_score"] = max(err["router_score"], e_s)
        err["router_cascade"] = max(err["router_cascade"], e_c)
        cases.append({"kernel": "router", "B": B, "err_score": e_s,
                      "err_cascade": e_c, "choice_diff": [d_s, d_c],
                      "near_tie_rows": [n_s, n_c], "esc_diff": [d_e, n_e]})
    attn_cases = [(32, 4, 32, False, 0, 0.0), (32, 4, 40, False, 0, 0.0),
                  (32, 8, 32, False, 0, 0.0), (32, 8, 40, False, 0, 0.0),
                  (4, 4, 40, True, 32, 30.0)]
    for B, H, hd, causal, window, softcap in attn_cases:
        g = torch.Generator(device="cuda").manual_seed(H * hd)
        q, k, v = (torch.randn(B, 128, H, hd, device="cuda", generator=g)
                   for _ in range(3))
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        torch.cuda.synchronize()
        ref = fa_ops.attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        e = float((out - ref).abs().max())
        check(e <= ATTN_TOL, f"flash_attention B={B} H={H} hd={hd}: "
                             f"max abs err {e}")
        err["flash_attention"] = max(err["flash_attention"], e)
        cases.append({"kernel": "flash_attention", "BH": B * H, "S": 128,
                      "hd": hd, "causal": causal, "window": window,
                      "softcap": softcap, "max_abs_err": e})
    emit("parity", tolerances={"router": ROUTER_TOL, "attention": ATTN_TOL,
                               "choice_gap": CHOICE_GAP},
         max_abs_err=err, cases=cases)
    return err


# -------------------------------------------------------------- phase 4

def make_requests(Request, parse_flags, mb, thr):
    """256 requests: prompt i % 192, the flag text i % 6, and a
    confidence floor on the admission batches 1 and 5 (a quarter)."""
    reqs = []
    for i in range(N_REQUESTS):
        j = i % N_UNIQUE
        cascade = (i // MAX_BATCH) % 4 == 1
        reqs.append(Request(uid=i, tokens=mb["tokens"][j],
                            targets=mb["targets"][j], mask=mb["mask"][j],
                            lambdas=parse_flags(FLAG_TEXTS[i % len(FLAG_TEXTS)]),
                            min_confidence=thr if cascade else 0.0))
    return reqs


def main_path_phase(torch) -> dict:
    from repro_torch.core import objective
    from repro_torch.core.library import ModelLibrary, paper_library_specs
    from repro_torch.core.router import (RouterConfig, init_router,
                                         predict_losses, predict_uncertainty)
    from repro_torch.data.batching import mlm_batch
    from repro_torch.data.corpus import DOMAINS, DomainCorpus
    from repro_torch.kernels import launches
    from repro_torch.models.model import count_params, init_model
    from repro_torch.serving import (Request, TryageEngine, lambda_matrix,
                                     parse_flags)

    t_setup = time.perf_counter()
    lib = ModelLibrary(paper_library_specs(vocab=512))
    for i, e in enumerate(lib.experts):
        e.params = init_model(e.cfg, seed=100 + i, device="cuda")
        e.n_params = count_params(e.params)
    rc = RouterConfig(n_models=len(lib), vocab_size=512)
    router = init_router(rc, seed=7, uncertainty=True, device="cuda")
    cons = [objective.size_constraint(lib), objective.recency_constraint(lib)]
    corpus = DomainCorpus(vocab_size=512, seed=0)
    rng = np.random.default_rng(0)
    toks, _ = corpus.sample_mixture({d: 1.0 for d in DOMAINS}, N_UNIQUE, SEQ,
                                    rng)
    mb = mlm_batch(toks, rng, 0.15, 512)

    # threshold: the median confidence of the cascade rows' first picks,
    # so some rows escalate and some do not
    probe = make_requests(Request, parse_flags, mb, 1.0)
    casc = [r for r in probe if r.min_confidence > 0]
    with torch.inference_mode():
        tk = torch.from_numpy(np.stack([r.tokens for r in casc])).cuda()
        pred = predict_losses(router, rc, {"tokens": tk}).cpu().numpy()
        sigma = predict_uncertainty(router, rc, {"tokens": tk}).cpu().numpy()
    cnames = [c.name for c in cons]
    cmat = objective.constraint_matrix(cons, len(lib))
    scores = pred + lambda_matrix(casc, cnames) @ cmat
    first = scores.argmin(1)
    conf = objective.confidence_scores(sigma)[np.arange(len(casc)), first]
    thr = float(np.median(conf))

    def engine(library, rtr, device):
        return TryageEngine(library, rtr, rc, cons, max_batch=MAX_BATCH,
                            fused_cascade=True, device=device)

    def serve(eng, reqs):
        for r in reqs:
            eng.submit(r)
        return {r.uid: r for r in eng.run()}

    setup_s = time.perf_counter() - t_setup
    serve(engine(lib, router, "cuda"),
          make_requests(Request, parse_flags, mb, thr))       # warm-up
    torch.cuda.synchronize()
    eng = engine(lib, router, "cuda")
    reqs = make_requests(Request, parse_flags, mb, thr)
    torch.cuda.reset_peak_memory_stats()
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check(sorted(res) == list(range(N_REQUESTS)), "not one Result per request")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    for r in res.values():
        check(r.loss is not None and np.isfinite(r.loss)
              and 0.0 <= r.accuracy <= 1.0, f"uid {r.uid}: bad loss/accuracy")
        check(r.predictions.shape == (SEQ,)
              and r.pred_losses.shape == (len(lib),)
              and np.isfinite(r.pred_losses).all(), f"uid {r.uid}: bad shape")
    n_casc = sum(r.min_confidence > 0 for r in reqs)
    esc = eng.stats.escalations
    check(0 < esc < n_casc, f"{esc} of {n_casc} cascade rows escalated")

    # one more run under the profiler: where the device time goes
    profile = device_profile(torch, lambda: serve(
        engine(lib, router, "cuda"),
        make_requests(Request, parse_flags, mb, thr)))
    # busy share against the timed (unprofiled) run of the same work
    profile["busy_share"] = profile["device_busy_ms"] / (wall * 1e3)

    # the first 64 requests (one single-shot batch, one cascade batch)
    # again, on the CPU with the same weights through the plain versions
    lib_cpu = copy.deepcopy(lib)
    for e in lib_cpu.experts:
        e.params.cpu()
    cpu = serve(engine(lib_cpu, copy.deepcopy(router).cpu(), "cpu"),
                make_requests(Request, parse_flags, mb, thr)[:64])
    mismatched, excused = [], 0
    for uid, c in cpu.items():
        g = res[uid]
        if (g.expert, g.cascade_depth) == (c.expert, c.cascade_depth):
            check(abs(g.loss - c.loss) <= NLL_ATOL,
                  f"uid {uid}: NLL {g.loss} on the card, {c.loss} on CPU")
            continue
        s = np.sort(c.pred_losses
                    + lambda_matrix([reqs[uid]], cnames)[0] @ cmat)
        if s[1] - s[0] < CHOICE_GAP or abs(c.confidence - thr) < CHOICE_GAP:
            excused += 1
        mismatched.append(uid)
    check(len(mismatched) == excused,
          f"card and CPU engines disagree on uids {mismatched}")
    out = {"requests": N_REQUESTS, "wall_s": wall,
           "req_per_s": N_REQUESTS / wall, "setup_s": setup_s,
           "peak_memory_bytes": peak, "launches": counts,
           "threshold": thr, "cascade_rows": n_casc, "escalations": esc,
           "depth_hist": {int(k): v for k, v in
                          sorted(eng.stats.cascade_depth_hist.items())},
           "router_time_s": eng.stats.router_time_s,
           "expert_time_s": eng.stats.expert_time_s,
           "profiled_run": profile,
           "cache_hits": eng.stats.cache_hits,
           "router_batches": eng.stats.router_batches,
           "bucket_hits": {int(k): v for k, v in
                           sorted(eng.stats.bucket_hits.items())},
           "per_expert": dict(eng.stats.per_expert),
           "mean_loss": float(np.mean([r.loss for r in res.values()])),
           "cpu_rerun": {"requests": len(cpu), "mismatched": mismatched,
                         "near_tie_excused": excused}}
    emit("main_path", **out)
    return out


# -------------------------------------------------------------- phase 5

def device_profile(torch, fn, top=8) -> dict:
    """Kernel time on the card for one call of ``fn`` under the
    profiler, with the top kernels.  The profiled wall time includes the
    profiler's own start-up and is reported only as such."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")
         and e.self_device_time_total > 0), key=lambda k: -k[1])
    return {"profiled_wall_ms": wall_ms,
            "device_busy_ms": sum(k[1] for k in kernels),
            "top_kernels": [{"name": n[:80], "ms": t, "count": c}
                            for n, t, c in kernels[:top]]}


def events_ms(torch, fn, iters=200, warmup=20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(torch, fn, kernel: str, iters=50):
    """Mean device time of CUDA kernel ``kernel`` over ``iters`` calls,
    from the profiler's trace; None if the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if evt.key == kernel and evt.count:
            total = getattr(evt, "device_time_total",
                            getattr(evt, "cuda_time_total", 0.0))
            return total / evt.count / 1e3 if total else None
    return None


def times_phase(torch, launches_per_run: dict, err: dict) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.router_cascade import ops as rc_ops
    from repro_torch.kernels.router_score import ops as rs_ops

    B, d, hh, M, n_c = 32, 128, 128, 11, 2
    t = head_inputs(torch, B, M, d, hh, n_c, seed=1)
    head_bytes = 4 * (d * hh + hh + hh * M + M)
    io_bytes = 4 * (B * d + n_c * M + B * n_c + B * M + B)
    head_flops = 2 * B * d * hh + 2 * B * hh * M
    sa = [t[k] for k in SCORE_ARGS]
    ca = [t[k] for k in CASCADE_ARGS]
    rows = [
        ("router_score", lambda: rs_ops.router_score_fused(*sa),
         lambda: rs_ops.router_score_plain(*sa), None,
         head_bytes + io_bytes, head_flops + 2 * B * n_c * M,
         {"B": B, "d": d, "hh": hh, "M": M, "n_c": n_c}),
        ("router_cascade", lambda: rc_ops.router_score_cascade_fused(*ca),
         lambda: rc_ops.router_cascade_plain(*ca), None,
         2 * head_bytes + io_bytes + 4 * (B * M + B + M),
         2 * head_flops + 2 * B * n_c * M,
         {"B": B, "d": d, "hh": hh, "M": M, "n_c": n_c}),
    ]
    extra = []
    for i, (Bq, H, hd) in enumerate(((32, 4, 32), (32, 4, 40), (32, 8, 32))):
        g = torch.Generator(device="cuda").manual_seed(H * hd)
        q, k, v = (torch.randn(Bq, 128, H, hd, device="cuda", generator=g)
                   for _ in range(3))
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        case = ("flash_attention", (lambda q=q, k=k, v=v:
                                     fa_ops.flash_attention(q, k, v,
                                                            causal=False)),
                (lambda q=q, k=k, v=v:
                 fa_ops.attention_plain(q, k, v, causal=False)),
                (lambda qh=qh, kh=kh, vh=vh:
                 F.scaled_dot_product_attention(qh, kh, vh)),
                4 * 4 * Bq * 128 * H * hd, 4 * Bq * H * 128 * 128 * hd,
                {"B": Bq, "H": H, "S": 128, "hd": hd, "causal": False})
        (rows if i == 0 else extra).append(case)
    kernels, extra_out = [], []
    for n, (name, kern, plain, libcall, nbytes, flops, shape) in enumerate(
            rows + extra):
        bms, by = bound_ms(nbytes, flops)
        entry = {"name": name, "route": "cuda", "source": SOURCES[name][0],
                 "replaces": SOURCES[name][1],
                 "launches": launches_per_run[name],
                 "max_abs_err": err[name],
                 "ms": events_ms(torch, kern),
                 "device_ms": profiled_ms(torch, kern, SOURCES[name][2]),
                 "plain_ms": events_ms(torch, plain),
                 "bound_ms": bms, "bound_by": by,
                 "library_ms": (events_ms(torch, libcall)
                                if libcall is not None else None),
                 "shape": shape}
        (kernels if n < len(rows) else extra_out).append(entry)
    emit("times", kernels=kernels, extra_shapes=extra_out,
         method="ms/plain_ms/library_ms: CUDA events over 200 back-to-back "
                "calls after 20 warm-up calls; device_ms: profiler device "
                "time of the kernel alone")
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from the root of "
              "a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    info = device_phase(torch)
    build_phase()
    err = parity_phase(torch)
    main = main_path_phase(torch)
    kernels = times_phase(torch, main["launches"], err)
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k != "shape"} for e in kernels]}),
        flush=True)
    emit("done", seconds=time.perf_counter() - t0)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
