#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
and holds each against its plain PyTorch version at its path's shapes.
Then it drives the port's two paths, each with the launch counts set to
0 just before it and read just after:

* ``main_path``: 256 requests through ``TryageEngine.run()`` over the
  paper-scale library (11 experts, vocab 512, seeded random weights)
  with the router's uncertainty head and the fused cascade on; the
  answers must match a CPU run of the same engine;
* ``xlstm_serve``: the full ``xlstm-1.3b`` config (48 layers, 3.43 B
  parameters, bf16, seeded random weights) prefills 4 prompts of 512
  tokens with ``prefill_step`` and greedy-decodes 32 tokens with
  ``serve_step``; ``xlstm_crosscheck`` runs a one-unit f32 copy of it at
  full width on the card and on the CPU and compares them, and holds
  decode against a longer prefill for the whole config in f32.

It checks that every kernel of each path was launched in that path's
run, and times each kernel beside its bound; the router heads also at
every bucket size the path launches them at, beside the launch floor
(the device time of an empty kernel, ``csrc/launch_floor.cu``).  Each
phase prints one JSON line; the line before the last is the card's
name and power limit from ``nvidia-smi``, the last is ``{"ok": true,
"device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result.
Without a CUDA card, or outside a checkout, it exits non-zero at once.

TF32 is off throughout for PyTorch's own products (it flips near-tie
argmins); the attention and mLSTM kernels run theirs on the tensor
cores in 3xTF32, which keeps f32 accuracy.  Times: CUDA events over
back-to-back calls after a warm-up, and the profiler's device time per
kernel.  Bounds: the larger of the bytes each call must move over 3.35
TB/s and its f32 operations over 67 TFLOP/s (H100 SXM data sheet); for
the tensor-core kernels also the larger of the bytes and three times the
operations over the TF32 tensor-core rate, 495 TFLOP/s (``bound_tc_ms``).
"""

from __future__ import annotations

import contextlib
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
TF32_TC_FLOPS_PER_S = 495e12   # dense TF32 tensor cores; 3xTF32 takes 3 passes
CHOICE_GAP = 1e-5          # a choice may differ only below this top-two gap
ROUTER_TOL = 1e-5          # router heads: pred / sigma vs the plain version
ATTN_TOL = 2e-5            # attention: online vs full softmax summation order
NLL_ATOL = 1e-4            # card vs CPU engine, per-request masked NLL
# mLSTM scan: max abs err of h, C1, n1, m1 each within this share of the
# reference's largest magnitude (f32 sums of up to 1024 terms in another
# order, and h divides by a running denominator)
MLSTM_REL_TOL = 1e-4
# xLSTM cross-check, card (kernel) vs CPU (plain), f32 at full width:
# logits and every state leaf within this share of the CPU's largest
# magnitude (8 layers of GEMMs summed in other orders); greedy tokens
# may differ only where the CPU's top-two logit gap is under TOKEN_GAP
XLSTM_REL_TOL = 1e-3
TOKEN_GAP = 1e-4
# decode one token from a prefill's state vs a prefill one token longer
# (tests/test_models_smoke.py's tolerance)
DECODE_ATOL, DECODE_RTOL = 2e-2, 1e-2
# through all 48 random layers, decode vs prefill logits may differ by at
# most this many times the change one ulp of the first block's input makes
# (the two paths round differently in every layer, not in the first only,
# and each layer's difference is amplified by the layers after it; a wrong
# state or chunk gives a gap of the logits' own size)
ROUNDING_FACTOR = 10.0
XLSTM_ARCH, XLSTM_B, XLSTM_S, XLSTM_DECODE = "xlstm-1.3b", 4, 512, 32
CROSS_S, CROSS_DECODE = 128, 8

# the README's flag phrases; 192 unique prompts repeat with the same flags
FLAG_TEXTS = ["", "[Flag: Prefer small]", "[Flag: Smallest model]",
              "[Flag: Newest model]", "[Flag: Best model]",
              "[Flag: Small model] [Flag: Recent model]"]
N_REQUESTS, N_UNIQUE, SEQ, MAX_BATCH = 256, 192, 128, 32

# name: (source, the TPU kernel it replaces, the name its device
# functions carry in ptxas, cuobjdump and the profiler)
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
    "mlstm_scan": ("src/repro_torch/kernels/csrc/mlstm_scan.cu",
                   "src/repro/kernels/mlstm_scan/kernel.py:36",
                   "mlstm_scan"),
}
ROUTER_PATH = ("router_score", "router_cascade", "flash_attention")
# kernels whose products run on the tensor cores (3xTF32)
TENSOR_CORE = ("flash_attention", "mlstm_scan")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
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


def sass_mma(build, lib) -> dict:
    """Per device function of the built library: how many tensor-core
    instructions (HMMA) its SASS holds, and which kinds, from
    ``cuobjdump -sass``."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib.path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(),
                                 {"hmma": 0, "kinds": []})
        elif cur is not None and "HMMA" in line:
            cur["hmma"] += 1
            kind = line[line.index("HMMA"):].split()[0]
            if kind not in cur["kinds"]:
                cur["kinds"].append(kind)
    return out


def build_phase() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.library()
    ptxas = build.ptxas_summary(lib.ptxas_log)
    sass = sass_mma(build, lib)
    kernels = {}
    for name, (_, _, entry) in SOURCES.items():
        # a kernel may be several device functions (template instances,
        # or launches): every one must build without spilling
        funcs = {fn: info for fn, info in ptxas.items() if entry in fn}
        check(bool(funcs), f"ptxas reported nothing for {entry}")
        for fn, info in funcs.items():
            check(info.get("spill_stores", 0) == 0
                  and info.get("spill_loads", 0) == 0,
                  f"{fn} spills registers: {info}")
            if name in TENSOR_CORE:
                mma = sass.get(fn, {"hmma": 0, "kinds": []})
                check(mma["hmma"] > 0
                      and all("TF32" in k for k in mma["kinds"]),
                      f"{fn}: no TF32 tensor-core instructions in its SASS "
                      f"({mma})")
                info = {**info, "sass_hmma": mma["hmma"],
                        "sass_hmma_kinds": mma["kinds"]}
            kernels.setdefault(name, {})[fn] = info
    emit("build", library=str(lib.path.relative_to(ROOT)),
         nvcc_seconds=lib.build_seconds,
         load_seconds=time.perf_counter() - t0, kernels=kernels)


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
    from repro_torch.kernels.mlstm_scan import ops as ml_ops
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
    for B, S, H, dh, carried in ((1, 64, 1, 16, False), (2, 96, 2, 64, True),
                                 (XLSTM_B, XLSTM_S, 4, 1024, False)):
        args = mlstm_inputs(torch, B, S, H, dh, carried, seed=S + dh)
        h, st = ml_ops.mlstm_chunkwise(*args)
        torch.cuda.synchronize()
        refs = {"chunkwise": ml_ops.mlstm_chunkwise_plain(*args)}
        if S * dh <= 96 * 64:
            refs["sequential"] = ml_ops.mlstm_sequential(*args)
        case = {"kernel": "mlstm_scan", "B": B, "S": S, "H": H, "dh": dh,
                "carried_state": carried}
        for rname, (rh, rst) in refs.items():
            for leaf, got, want in (("h", h, rh), ("C", st["C"], rst["C"]),
                                    ("n", st["n"], rst["n"]),
                                    ("m", st["m"], rst["m"])):
                e, scale = float((got - want).abs().max()), float(
                    want.abs().max())
                check(bool(torch.isfinite(got).all())
                      and e <= MLSTM_REL_TOL * scale,
                      f"mlstm_scan {case} {leaf} vs {rname}: max abs err "
                      f"{e}, reference max {scale}")
                case[f"{leaf}_vs_{rname}"] = [e, scale]
                err["mlstm_scan"] = max(err["mlstm_scan"], e)
        cases.append(case)
    emit("parity", tolerances={"router": ROUTER_TOL, "attention": ATTN_TOL,
                               "choice_gap": CHOICE_GAP,
                               "mlstm_rel_to_max": MLSTM_REL_TOL},
         max_abs_err=err, cases=cases)
    return err


def mlstm_inputs(torch, B, S, H, dh, carried, seed):
    """q, k, v, i, f, state for the mLSTM scan: normal q/k/v and input
    gates, forget gates biased by +3 as the model's ``b_if`` is; a
    carried state is small and random, else zeros."""
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


@contextlib.contextmanager
def batch_sizes(module, fn_name: str):
    """Within the block, count the batch sizes (the first argument's
    first dimension) passed to ``module.fn_name``, the name its callers
    reach, in a dict batch size -> calls.  The wrapper itself and its
    launch count are untouched."""
    inner, hist = getattr(module, fn_name), {}

    def counted(x, *args, **kwargs):
        hist[x.shape[0]] = hist.get(x.shape[0], 0) + 1
        return inner(x, *args, **kwargs)

    setattr(module, fn_name, counted)
    try:
        yield hist
    finally:
        setattr(module, fn_name, inner)


def main_path_phase(torch) -> dict:
    from repro_torch.core import objective
    from repro_torch.core.library import ModelLibrary, paper_library_specs
    from repro_torch.core.router import (RouterConfig, init_router,
                                         predict_losses, predict_uncertainty)
    from repro_torch.data.batching import mlm_batch
    from repro_torch.data.corpus import DOMAINS, DomainCorpus
    from repro_torch.kernels import launches
    from repro_torch.kernels.router_cascade import ops as rc_ops
    from repro_torch.kernels.router_score import ops as rs_ops
    from repro_torch.models import attention
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
    with batch_sizes(attention, "flash_attention") as batch_hist, \
            batch_sizes(rs_ops, "router_route") as score_hist, \
            batch_sizes(rc_ops, "router_route_cascade") as cascade_hist:
        t0 = time.perf_counter()
        res = serve(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launches.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check(sorted(res) == list(range(N_REQUESTS)), "not one Result per request")
    for name in ROUTER_PATH:
        check(counts[name] > 0,
              f"kernel {name} was not launched on the main path")
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
        make_requests(Request, parse_flags, mb, thr)),
        match={name: SOURCES[name][2] for name in ROUTER_PATH})
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
           "attention_batch_hist": dict(sorted(batch_hist.items())),
           "router_batch_hist": {
               "router_score": dict(sorted(score_hist.items())),
               "router_cascade": dict(sorted(cascade_hist.items()))},
           "router_tiles": eng.stats.router_tiles,
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


# ------------------------------------------------------------ phase 4b

def xlstm_prompts(corpus, B: int, S: int, seed: int = 0):
    """B prompts of S tokens from the port's ``DomainCorpus``, uniform
    over its domains, as ``repro/launch/train.py`` draws them."""
    vocab = corpus.vocab_size
    rng = np.random.default_rng(seed)
    uniform = {d: 1.0 / len(corpus.tables) for d in corpus.tables}
    toks, _ = corpus.sample_mixture(uniform, B, S, rng)
    return np.clip(toks, 0, vocab - 1)


def greedy(torch, model, tokens, steps, device):
    """prefill_step, then ``steps`` serve_step calls.  Returns (last
    prefill logits, generated tokens (B, steps + 1), per-step decode
    logits, final state, mlstm_scan launches in the prefill, in the
    decode)."""
    from repro_torch.kernels import launches
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models import model as model_lib
    launches.reset_launch_counts()
    last, state = prefill_step(model, {"tokens": tokens}, device=device)
    n_prefill = launches.launch_counts()["mlstm_scan"]
    tok = last.argmax(-1).to(torch.int32)[:, None]
    out, dec_logits = [tok], []
    S = tokens.shape[1]
    with torch.inference_mode():
        for t in range(steps):
            # the step's logits, for the checks; serve_step returns tokens
            lg, _ = model_lib.decode_step(model, {"tokens": tok}, state, S + t)
            dec_logits.append(lg.float())
            tok, state = serve_step(model, state, tok, S + t, device=device)
            out.append(tok)
    n_decode = launches.launch_counts()["mlstm_scan"] - n_prefill
    return last, torch.cat(out, 1), dec_logits, state, n_prefill, n_decode


def layer_times(torch, model, fn) -> dict:
    """Host seconds per block kind over one call of ``fn``, with a
    device sync around every layer (forward hooks): where a prefill or
    decode step spends its time, layer kind by layer kind."""
    acc: dict = {}
    t0 = {}

    def pre(block, args, kwargs):
        torch.cuda.synchronize()
        t0[block] = time.perf_counter()

    def post(block, args, kwargs, out):
        torch.cuda.synchronize()
        acc[block.kind] = acc.get(block.kind, 0.0) + (
            time.perf_counter() - t0[block])

    hooks = [h for b in model.layers for h in (
        b.register_forward_pre_hook(pre, with_kwargs=True),
        b.register_forward_hook(post, with_kwargs=True))]
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        acc["total"] = time.perf_counter() - t
    finally:
        for h in hooks:
            h.remove()
    return {k: v * 1e3 for k, v in acc.items()}


def xlstm_serve_phase(torch):
    """Returns (the phase's line, the corpus it drew prompts from)."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import DomainCorpus
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models import model as model_lib

    cfg = get_config(XLSTM_ARCH)
    n_mlstm = cfg.num_units * cfg.layer_pattern.count("mlstm")
    t_setup = time.perf_counter()
    corpus = DomainCorpus(vocab_size=cfg.vocab_size)
    corpus_s = time.perf_counter() - t_setup
    model = model_lib.init_model(cfg, seed=0, device="cuda")
    n_params = model_lib.count_params(model)
    prompts = torch.from_numpy(xlstm_prompts(corpus, XLSTM_B, XLSTM_S)).cuda()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup

    # warm-up: one prefill and two decode steps
    _, st = prefill_step(model, {"tokens": prompts})
    tok = prompts[:, -1:]
    for t in range(2):
        tok, st = serve_step(model, st, tok, XLSTM_S + t)
    del st
    torch.cuda.synchronize()

    from repro_torch.kernels import launches
    torch.cuda.reset_peak_memory_stats()
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    last, state = prefill_step(model, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts_prefill = launches.launch_counts()
    tok = last.argmax(-1).to(torch.int32)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for t in range(XLSTM_DECODE):
        tok, state = serve_step(model, state, tok, XLSTM_S + t)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = launches.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    generated = torch.cat(generated, 1)

    check(n_params == 3_426_709_840, f"xlstm-1.3b has {n_params} parameters")
    check(bool(torch.isfinite(last).all()), "non-finite prefill logits")
    check(counts_prefill["mlstm_scan"] == n_mlstm,
          f"{counts_prefill['mlstm_scan']} mlstm_scan launches in the "
          f"prefill, want {n_mlstm}")
    check(counts["mlstm_scan"] == n_mlstm, "mlstm_scan launched in decode")
    check(all(bool(torch.isfinite(s["m"]).all()) for s in state),
          "a layer's stabiliser m is not finite")
    check(generated.shape == (XLSTM_B, XLSTM_DECODE + 1)
          and bool(((generated >= 0) & (generated < cfg.vocab_size)).all()),
          "bad generated tokens")

    # decode vs a prefill one longer, beside the model's own sensitivity
    # to one rounding (printed, not gated: bf16 through 48 random layers)
    dvp = decode_vs_prefill(torch, model, prompts, jitter=True)
    check(dvp["finite"], "non-finite decode logits")

    # where the time goes: per layer kind (synced), and the profiler
    with torch.inference_mode():
        by_kind_prefill = layer_times(
            torch, model, lambda: model_lib.prefill(model, {"tokens": prompts}))
        _, st = model_lib.prefill(model, {"tokens": prompts})
        by_kind_decode = layer_times(
            torch, model, lambda: model_lib.decode_step(
                model, {"tokens": tok}, st, XLSTM_S))
    prof_prefill = device_profile(
        torch, lambda: prefill_step(model, {"tokens": prompts}),
        match={"mlstm_scan": SOURCES["mlstm_scan"][2]})
    prof_prefill["busy_share"] = prof_prefill["device_busy_ms"] / (
        prefill_s * 1e3)
    prof_decode = device_profile(
        torch, lambda: serve_step(model, st, tok, XLSTM_S))
    prof_decode["busy_share"] = prof_decode["device_busy_ms"] / (
        decode_s * 1e3 / XLSTM_DECODE)
    del model, state, st
    torch.cuda.empty_cache()

    out = {"arch": XLSTM_ARCH, "layers": cfg.num_layers,
           "params": n_params, "dtype": cfg.dtype, "batch": XLSTM_B,
           "prompt_len": XLSTM_S, "decode_steps": XLSTM_DECODE,
           "setup_s": setup_s, "corpus_s": corpus_s,
           "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": XLSTM_B * XLSTM_S / prefill_s,
           "decode_ms_per_step": decode_s * 1e3 / XLSTM_DECODE,
           "decode_tokens_per_s": XLSTM_B * XLSTM_DECODE / decode_s,
           "peak_memory_bytes": peak, "launches": counts,
           "decode_vs_prefill_max_logit_gap_bf16": dvp["max_abs_err"],
           "prefill_logit_max_abs_bf16": dvp["logit_max_abs"],
           "one_ulp_logit_change_bf16": dvp["one_ulp_logit_change"],
           "decode_vs_prefill_layer_err_bf16": dvp["layer_err"],
           "layer_ms_prefill": by_kind_prefill,
           "layer_ms_decode_step": by_kind_decode,
           "profiled_prefill": prof_prefill,
           "profiled_decode_step": prof_decode,
           "first_tokens": generated[:, :8].cpu().tolist()}
    emit("xlstm_serve", **out)
    return out, corpus


def ulp_jitter(torch, x, seed=0):
    """``x`` with each non-zero element's magnitude moved one unit in
    the last place up or down (seeded): a change of the size of one
    rounding."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]
    g = torch.Generator(x.device).manual_seed(seed)
    step = torch.randint(0, 2, x.shape, generator=g, device=x.device,
                         dtype=ints) * 2 - 1
    moved = (x.contiguous().view(ints) + step).view(x.dtype)
    return torch.where(x == 0, x, moved)


def last_hidden(torch, model, fn, jitter=False):
    """(``fn()``, each block's output at the last position).  With
    ``jitter`` the first block's input goes through ``ulp_jitter``."""
    outs = []
    hooks = [b.register_forward_hook(
        lambda block, args, out: outs.append(out[0][:, -1].float()))
        for b in model.layers]
    if jitter:
        hooks.append(model.layers[0].register_forward_pre_hook(
            lambda block, args: (ulp_jitter(torch, args[0]),) + args[1:]))
    try:
        with torch.inference_mode():
            return fn(), outs
    finally:
        for h in hooks:
            h.remove()


def decode_vs_prefill(torch, model, prompt, jitter=False):
    """Decode the greedy next token from a prefill's state against a
    prefill over the prompt and that token, layer by layer at that
    position.  Returns {"max_abs_err" (logits), "logit_max_abs",
    "close" (logits at DECODE_ATOL/RTOL), "layer_err",
    "layers_close"}; with ``jitter`` also "one_ulp_logit_change": how
    far that longer prefill's logits move when the first block's input
    moves by one ulp (``ulp_jitter``), the model's own sensitivity to
    rounding."""
    from repro_torch.models import model as model_lib
    S = prompt.shape[1]
    with torch.inference_mode():
        logits, st = model_lib.prefill(model, {"tokens": prompt})
    tok = logits[:, -1:].argmax(-1)
    del logits
    dec, dec_h = last_hidden(torch, model, lambda: model_lib.decode_step(
        model, {"tokens": tok}, st, S)[0].float())
    del st
    toks = torch.cat([prompt, tok], 1)
    full, full_h = last_hidden(torch, model, lambda: model_lib.prefill(
        model, {"tokens": toks})[0][:, S].float())
    out = {"max_abs_err": float((dec - full).abs().max()),
           "logit_max_abs": float(full.abs().max()),
           "finite": bool(torch.isfinite(dec).all()),
           "close": torch.allclose(dec, full, atol=DECODE_ATOL,
                                   rtol=DECODE_RTOL),
           "layer_err": [float((a - b).abs().max())
                         for a, b in zip(dec_h, full_h)],
           "layers_close": [torch.allclose(a, b, atol=DECODE_ATOL,
                                           rtol=DECODE_RTOL)
                            for a, b in zip(dec_h, full_h)]}
    if jitter:
        moved, _ = last_hidden(torch, model, lambda: model_lib.prefill(
            model, {"tokens": toks})[0][:, S].float(), jitter=True)
        out["one_ulp_logit_change"] = float((moved - full).abs().max())
    return out


def xlstm_crosscheck_phase(torch, corpus) -> dict:
    """A one-unit (8-layer) f32 copy of the config at full width: the
    card (mLSTM kernel) against the CPU (plain versions) on the same
    weights, and on the card decode against prefill; then decode against
    prefill for the whole 48-layer config in f32 on the card.  The
    weights are drawn on the card, where truncated normals are quick,
    and the 8-layer copy is deep-copied to the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = dataclasses.replace(get_config(XLSTM_ARCH),
                              num_layers=len(get_config(XLSTM_ARCH)
                                             .layer_pattern),
                              dtype="float32")
    t0 = time.perf_counter()
    gpu = model_lib.init_model(cfg, seed=1, device="cuda")
    cpu = copy.deepcopy(gpu).cpu()
    setup_s = time.perf_counter() - t0
    prompt = torch.from_numpy(xlstm_prompts(corpus, 1, CROSS_S, seed=1))
    res = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, None)):
        t0 = time.perf_counter()
        res[name] = greedy(torch, model, prompt.to(dev or "cuda"),
                           CROSS_DECODE - 1, dev)
        res[name + "_s"] = time.perf_counter() - t0
    last_c, toks_c, dec_c, st_c, pre_c, _ = res["cpu"]
    last_g, toks_g, dec_g, st_g, pre_g, dcd_g = res["cuda"]
    n_mlstm = cfg.layer_pattern.count("mlstm")
    check(pre_c == 0 and (pre_g, dcd_g) == (n_mlstm, 0),
          f"mlstm_scan launches: cpu {pre_c}, card {pre_g} + {dcd_g}")

    def rel(got, want):
        return float((got.cpu().float() - want.float()).abs().max()) / max(
            float(want.abs().max()), 1e-30)

    e_logits = rel(last_g, last_c)
    check(e_logits <= XLSTM_REL_TOL, f"prefill logits: rel err {e_logits}")
    e_state = 0.0
    for i, (sg, sc) in enumerate(zip(st_g, st_c)):
        for leaf in sc:
            e = rel(sg[leaf], sc[leaf])
            check(e <= XLSTM_REL_TOL, f"layer {i} state {leaf}: rel err {e}")
            e_state = max(e_state, e)
    # tokens: identical, or first differing where the CPU's top-two
    # logit gap is under TOKEN_GAP (the rest then follow other inputs)
    logits_c = [last_c] + dec_c
    first_diff, excused = None, False
    for t in range(toks_c.shape[1]):
        if not torch.equal(toks_g[:, t].cpu(), toks_c[:, t]):
            top2 = logits_c[t][0].topk(2).values
            first_diff = t
            excused = float(top2[0] - top2[1]) < TOKEN_GAP
            break
    check(first_diff is None or excused,
          f"card and CPU tokens differ at step {first_diff}")

    # on the card: decode one token vs a prefill over S + 1 tokens
    unit = decode_vs_prefill(torch, gpu, prompt.cuda())
    check(unit["close"], f"decode vs prefill on the card: max abs err "
          f"{unit['max_abs_err']}")
    n_params = model_lib.count_params(gpu)
    del cpu, gpu
    torch.cuda.empty_cache()

    # the same for the whole config in f32 on xlstm_serve's prompts, whose
    # S + 1 = 513 tokens run in chunks of 57, not 64.  Through 48 random
    # layers a one-ulp change of the input already moves the logits by
    # more than the JAX test's tolerance, so the first unit is held to
    # that tolerance layer by layer, and the logits to ROUNDING_FACTOR
    # times the model's own one-ulp sensitivity.
    model = model_lib.init_model(dataclasses.replace(
        get_config(XLSTM_ARCH), dtype="float32"), seed=0, device="cuda")
    prompts = torch.from_numpy(xlstm_prompts(corpus, XLSTM_B, XLSTM_S)).cuda()
    deep = decode_vs_prefill(torch, model, prompts, jitter=True)
    del model
    torch.cuda.empty_cache()
    n_unit = len(cfg.layer_pattern)
    out = {"layers": cfg.num_layers, "d_model": cfg.d_model, "dtype": "f32",
           "params": n_params, "batch": 1,
           "prompt_len": CROSS_S, "tokens": CROSS_DECODE, "setup_s": setup_s,
           "cpu_s": res["cpu_s"], "card_s": res["cuda_s"],
           "launches_prefill": pre_g, "launches_decode": dcd_g,
           "logits_rel_err": e_logits, "state_rel_err": e_state,
           "tokens_identical": first_diff is None,
           "first_token_diff": first_diff,
           "decode_vs_prefill_max_abs_err": unit["max_abs_err"],
           "full_depth_f32": {
               "layers": len(deep["layer_err"]), "batch": XLSTM_B,
               "prompt_len": XLSTM_S,
               "decode_vs_prefill_max_abs_err": deep["max_abs_err"],
               "prefill_logit_max_abs": deep["logit_max_abs"],
               "one_ulp_logit_change": deep["one_ulp_logit_change"],
               "layer_err": deep["layer_err"]},
           "tolerances": {"rel_to_max": XLSTM_REL_TOL,
                          "token_gap": TOKEN_GAP,
                          "decode_atol": DECODE_ATOL,
                          "decode_rtol": DECODE_RTOL,
                          "rounding_factor": ROUNDING_FACTOR}}
    emit("xlstm_crosscheck", **out)
    check(all(deep["layers_close"][:n_unit]),
          f"decode vs prefill, first unit of the f32 config: max abs err by "
          f"layer {deep['layer_err'][:n_unit]}")
    check(deep["max_abs_err"] <= ROUNDING_FACTOR *
          deep["one_ulp_logit_change"],
          f"decode vs prefill of the f32 config: logits {deep['max_abs_err']}"
          f", one ulp moves them {deep['one_ulp_logit_change']}")
    return out


# -------------------------------------------------------------- phase 5

def device_profile(torch, fn, top=8, match=None) -> dict:
    """Kernel time on the card for one call of ``fn`` under the
    profiler, with the top kernels, and for each ``match`` entry (name:
    substring) the time of the kernels whose names hold the substring.
    The profiled wall time includes the profiler's own start-up and is
    reported only as such."""
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
    busy = sum(k[1] for k in kernels)
    out = {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
           "top_kernels": [{"name": n[:80], "ms": t, "count": c}
                           for n, t, c in kernels[:top]]}
    for name, sub in (match or {}).items():
        ms = sum(t for n, t, _ in kernels if sub in n)
        out[f"{name}_ms"] = ms
        out[f"{name}_share"] = ms / busy if busy else None
    return out


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


def profiled_kernels(torch, fn, iters=50) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` runs, over
    ``iters`` calls under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        if evt.self_device_time_total:
            out[evt.key] = (out.get(evt.key, 0.0)
                            + evt.self_device_time_total / iters / 1e3)
    return out


def profiled_ms(torch, fn, kernel: str, iters=50):
    """Device time per call of the CUDA kernels whose names hold
    ``kernel`` (all of a wrapper's launches), from the profiler's trace;
    None if the trace shows no device time for them."""
    ms = sum(t for n, t in profiled_kernels(torch, fn, iters).items()
             if kernel in n)
    return ms or None


def times_phase(torch, launches_per_run: dict, err: dict) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm_scan import ops as ml_ops
    from repro_torch.kernels.router_cascade import ops as rc_ops
    from repro_torch.kernels.router_score import ops as rs_ops

    B, d, hh, M, n_c = 32, 128, 128, 11, 2
    t = head_inputs(torch, B, M, d, hh, n_c, seed=1)
    sa = [t[k] for k in SCORE_ARGS]
    ca = [t[k] for k in CASCADE_ARGS]
    shape = {"B": B, "d": d, "hh": hh, "M": M, "n_c": n_c}
    rows = [
        ("router_score", lambda: rs_ops.router_score_fused(*sa),
         lambda: rs_ops.router_score_plain(*sa), None,
         *head_cost(B, d, hh, M, n_c, cascade=False), shape, None),
        ("router_cascade", lambda: rc_ops.router_score_cascade_fused(*ca),
         lambda: rc_ops.router_cascade_plain(*ca), None,
         *head_cost(B, d, hh, M, n_c, cascade=True), shape, None),
    ]
    B, S, H, dh = XLSTM_B, XLSTM_S, 4, 1024
    L = min(64, S)
    ml_args = mlstm_inputs(torch, B, S, H, dh, False, seed=2)
    rows.append(("mlstm_scan", lambda: ml_ops.mlstm_chunkwise(*ml_args),
                 lambda: ml_ops.mlstm_chunkwise_plain(*ml_args), None,
                 # q, k, v, h; C0, C1; n0, n1; i, f; m0, m1
                 4 * (4 * B * S * H * dh + 2 * B * H * dh * dh
                      + 2 * B * H * dh + 2 * B * S * H + 2 * B * H),
                 # per row and chunk: q k^T and (W*S) v, q C and k^T v
                 B * H * (S // L) * (4 * L * L * dh + 4 * L * dh * dh),
                 {"B": B, "S": S, "H": H, "dh": dh, "chunk": L}, None))
    extra = []
    # the main path's shape first, then hd 40, 8 heads, and the batch
    # sizes most of run()'s launches take (1 to 8)
    for i, (Bq, H, hd) in enumerate(((32, 4, 32), (32, 4, 40), (32, 8, 32),
                                     (1, 4, 32), (8, 4, 32))):
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
                {"B": Bq, "H": H, "S": 128, "hd": hd, "causal": False},
                (lambda q=q, k=k, v=v, qh=qh, kh=kh, vh=vh: float((
                    F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2)
                    - fa_ops.attention_plain(q, k, v, causal=False))
                    .abs().max())))
        (rows if i == 0 else extra).append(case)
    kernels, extra_out = [], []
    for n, (name, kern, plain, libcall, nbytes, flops, shape,
            lib_err) in enumerate(rows + extra):
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
        if name in TENSOR_CORE:
            entry["bound_tc_ms"], entry["bound_tc_by"] = bound_ms(
                nbytes, 3 * flops, TF32_TC_FLOPS_PER_S)
        if libcall is not None:
            # the library call's own kernels, device time and error
            lib_k = profiled_kernels(torch, libcall)
            entry["library_kernel"] = max(lib_k, key=lib_k.get)[:80]
            entry["library_device_ms"] = sum(lib_k.values())
            entry["library_max_abs_err"] = lib_err()
        (kernels if n < len(rows) else extra_out).append(entry)
    emit("times", kernels=kernels, extra_shapes=extra_out,
         launch_floor=launch_floor(torch, rs_ops.decision_plan(32, d, hh)),
         router_buckets=router_buckets(
             torch, rs_ops, rc_ops, d, hh, M, n_c),
         method="ms/plain_ms/library_ms: CUDA events over 200 back-to-back "
                "calls after 20 warm-up calls; device_ms/library_device_ms: "
                "profiler device time of the call's kernels alone; "
                "library_max_abs_err: the library call against the plain "
                "version; launch_floor: an empty kernel through the "
                "wrappers' launch path, at one warp and at the "
                "router_score grid and block for B=32")
    return kernels


def head_cost(B, d, hh, M, n_c, cascade) -> tuple[int, int]:
    """(bytes, f32 operations) of one router-head call: weights, rows
    and outputs moved once; both layers' products and the constraint
    add."""
    heads = 2 if cascade else 1
    head_bytes = 4 * (d * hh + hh + hh * M + M)
    io_bytes = 4 * (B * d + n_c * M + B * n_c + B * M + B)
    if cascade:     # sigma, esc, ladder_pos
        io_bytes += 4 * (B * M + B + M)
    head_flops = 2 * B * d * hh + 2 * B * hh * M
    return heads * head_bytes + io_bytes, (heads * head_flops
                                           + 2 * B * n_c * M)


def launch_floor(torch, plan: dict) -> dict:
    """Events and device time of the empty kernel ``launch_floor_kernel``
    (``csrc/launch_floor.cu``) launched through ``build.launch``: one
    block of one warp, and the grid and block of ``plan`` (a router
    kernel's launch at B=32)."""
    from repro_torch.kernels import build
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"source": "src/repro_torch/kernels/csrc/launch_floor.cu"}
    for key, grid, threads in (("one_warp", 1, 32),
                               ("b32", plan["grid"], plan["threads"])):
        fn = (lambda grid=grid, threads=threads:
              build.launch("tryage_launch_floor", dev, grid, threads))
        out[key] = {"grid": grid, "threads": threads,
                    "ms": events_ms(torch, fn),
                    "device_ms": profiled_ms(torch, fn,
                                             "launch_floor_kernel")}
    return out


def router_buckets(torch, rs_ops, rc_ops, d, hh, M, n_c) -> list:
    """Both router heads at every bucket size ``run()`` launches them
    at: events and device time beside the bound and the launch plan."""
    out = []
    for B in (1, 2, 4, 8, 16, 32):
        t = head_inputs(torch, B, M, d, hh, n_c, seed=B)
        row = {"B": B}
        for name, fn, args, cascade in (
                ("router_score", rs_ops.router_score_fused, SCORE_ARGS,
                 False),
                ("router_cascade", rc_ops.router_score_cascade_fused,
                 CASCADE_ARGS, True)):
            call = (lambda fn=fn, a=[t[k] for k in args]: fn(*a))
            bms, _ = bound_ms(*head_cost(B, d, hh, M, n_c, cascade))
            plan = (rc_ops.decision_plan(B, d, hh) if cascade
                    else rs_ops.decision_plan(B, d, hh))
            row[name] = {"ms": events_ms(torch, call),
                         "device_ms": profiled_ms(torch, call,
                                                  SOURCES[name][2]),
                         "bound_ms": bms, "threads": plan["threads"],
                         "k_groups": plan["k_groups"]}
        out.append(row)
    return out


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
    xlstm, corpus = xlstm_serve_phase(torch)
    xlstm_crosscheck_phase(torch, corpus)
    # launches of each kernel in the run of the path that uses it
    path_launches = {n: main["launches"][n] for n in ROUTER_PATH}
    path_launches["mlstm_scan"] = xlstm["launches"]["mlstm_scan"]
    kernels = times_phase(torch, path_launches, err)
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
