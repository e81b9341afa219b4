#!/usr/bin/env python3
"""Time the port's attention backward kernel against another tree's, in
one process on one card.

    python3 scripts/ab_flash_backward.py OTHER_TREE [--rounds N]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` of this
checkout and of ``OTHER_TREE`` (for example the parent commit, unpacked
with ``git archive``) with the flags of ``kernels/build.py`` (and, where
the tree has them, the parts of ``flash_attention_bwd_part.cu`` with its
``PARTS`` defines, all nvcc processes side by side), loads both
with ctypes, and times them at the training shapes (B, H, S = T, hd) =
(16, 8, 128, 32), (16, 4, 128, 40) and (32, 4, 128, 32), non-causal,
in turns: other, this, this, other, for ``--rounds`` rounds; then at
the zoo's bf16 training shapes (``chip_smoke.py``'s ``ZOO_ATTN_GRAD``:
GQA, causal, window and softcap as each config has them, with the
row-sum workspace where the kernel takes two launches).  Each turn
reports CUDA-event time over 200 launches after 20 warm-up launches (10
and 10 at the zoo's shapes) and the profiler's device time per call
(all of a call's launches), beside the bound (the larger of the bytes
over 3.35 TB/s and the five products' operations over the pairs the
masks leave, at the bf16 tensor cores' 989 TFLOP/s for bf16 and the f32
CUDA cores' 67 TFLOP/s for f32).  SDPA's
backward (``torch.autograd.grad`` through
``scaled_dot_product_attention``) is timed the same way in each round,
as the library yardstick.  Both trees get the same inputs and the same
log-sum-exp (computed in f32 by PyTorch); the gradients of each are
held against autograd of the plain version by ``chip_smoke.py``'s
``attention_grad`` gate (bf16: one bf16 ulp of the f32 gradient
rounded, plus ``ATTN_GRAD_REL_TOL`` of the largest) and a rerun must be
bit-identical; the exit code is 1 where a tree misses either.  Prints one JSON object with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((16, 8, 128, 32), (16, 4, 128, 40), (32, 4, 128, 32))
KERNEL = "flash_attention_bwd"   # in every device function's name


def build(tree: Path, out: Path) -> list:
    """Start nvcc on each backward unit of ``tree``; ``load`` links."""
    from repro_torch.kernels import build as kbuild
    csrc = tree / "src/repro_torch/kernels/csrc"
    units = [(csrc / "flash_attention_bwd.cu", ())]
    if (csrc / "flash_attention_bwd_part.cu").exists():
        units += [(csrc / "flash_attention_bwd_part.cu", d)
                  for d in kbuild.PARTS["flash_attention_bwd_part.cu"]]
    return [(subprocess.Popen(
        [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, *d, "-c", str(u), "-o",
         f"{out}.{i}.o"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        f"{out}.{i}.o") for i, (u, d) in enumerate(units)]


def load(tree: Path, out: Path, procs: list) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    for p, _ in procs:
        if p.wait(timeout=900):
            raise RuntimeError(p.stdout.read().decode())
    subprocess.run([kbuild.nvcc_path(), *kbuild.ARCH, "-shared", "-o",
                    str(out), *(o for _, o in procs)],
                   check=True, capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(str(out))
    fn = lib.tryage_flash_attention_bwd
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = (tree / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
            ).read_text()
    # a tree with two launches at every shape takes two (B, H, S)
    # workspaces; later designs one (B, H, S, 2), read past 128 keys
    # only (f32) or always (bf16, since its redesign); since bf16 came
    # in, an int says the inputs' type
    lib.two_workspaces = "float* dsum, float* lse_b" in text
    lib.dtype_flag = "int bf16, void* stream" in text
    fn.argtypes = ([P] * 5 + [P] * (5 if lib.two_workspaces else 4)
                   + [I] * 8 + [F] * 2 + [I] * lib.dtype_flag + [P])
    fn.restype = ctypes.c_int
    return lib


def log_sum_exp(q, k, scale, causal, window, softcap):
    """The forward's log-sum-exp of each row (B, H, S), in f32 by
    PyTorch: both trees read the same one."""
    import torch
    kr = k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float() * scale, kr)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    S, T = s.shape[-2:]
    i, j = torch.arange(S, device=s.device), torch.arange(T, device=s.device)
    ok = torch.ones(S, T, dtype=torch.bool, device=s.device)
    if causal:
        ok &= j[None, :] <= i[:, None]
    if window:
        ok &= j[None, :] > i[:, None] - window
    return torch.logsumexp(s.masked_fill(~ok, float("-inf")),
                           dim=-1).contiguous()


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_flash_backward: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream

    def events_ms(fn, iters=200):
        for _ in range(min(20, iters)):
            fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def device_ms(fn, match=None, iters=50):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        t = sum(ev.self_device_time_total for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA")
                and (match is None or match in ev.key))
        return t / iters / 1e3 or None

    results = []
    with tempfile.TemporaryDirectory() as tmp:
        trees = {"other": args.other.resolve(), "this": ROOT}
        procs = {n: build(t, Path(tmp) / f"{n}.so") for n, t in trees.items()}
        libs = {n: load(trees[n], Path(tmp) / f"{n}.so", procs[n])
                for n in trees}
        cases = [(B, S, H, H, hd, False, 0, 0.0, "float32", None)
                 for B, H, S, hd in SHAPES]
        sys.path.insert(0, str(ROOT))
        import chip_smoke
        cases += [(*c[:8], "bfloat16", c[8])
                  for c in chip_smoke.ZOO_ATTN_GRAD]
        for B, S, H, KV, hd, causal, window, softcap, dt, label in cases:
            g = torch.Generator(device="cuda").manual_seed(hd)
            q, do = (torch.randn(B, S, H, hd, device="cuda", generator=g)
                     .to(getattr(torch, dt)) for _ in range(2))
            k, v = (torch.randn(B, S, KV, hd, device="cuda", generator=g)
                    .to(getattr(torch, dt)) for _ in range(2))
            scale = 1.0 / math.sqrt(hd)
            masks = dict(causal=causal, window=window, softcap=softcap)
            lse = log_sum_exp(q, k, scale, **masks)
            grads = {n: tuple(torch.empty_like(x) for x in (q, k, v))
                     for n in libs}
            work = torch.empty(2, B, H, S, device="cuda")
            # the workspace wherever either tree takes two launches
            two = (fa.backward_launches(S, hd) == 2
                   or fa.backward_launches(S, hd, dt == "bfloat16") == 2)

            def call(name):
                lib, (dq, dk, dv) = libs[name], grads[name]
                ws = ([work[0].data_ptr(), work[1].data_ptr()]
                      if lib.two_workspaces
                      else [work.data_ptr() if two else None])
                err = lib.tryage_flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), *ws, dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B, S, S, H, KV, hd, int(causal), window,
                    softcap, scale,
                    *([int(dt == "bfloat16")] if lib.dtype_flag else []),
                    stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")

            qh, kh, vh = (a.repeat_interleave(H // a.shape[2], dim=2)
                          .transpose(1, 2).contiguous().requires_grad_(True)
                          for a in (q, k, v))
            mask = None
            if window > 0:
                i = torch.arange(S, device="cuda")
                mask = (i[None, :] <= i[:, None]) & (i[None, :]
                                                      > i[:, None] - window)
            with torch.enable_grad():
                oh = F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask,
                    is_causal=causal and mask is None)
            doh = do.transpose(1, 2).contiguous()

            def sdpa():
                return torch.autograd.grad(oh, (qh, kh, vh), doh,
                                           retain_graph=True)

            want = fa.attention_grad_plain(q.float(), k.float(), v.float(),
                                           do.float(), **masks)
            err, ok = {}, {}
            for name in libs:
                call(name)
                torch.cuda.synchronize()
                first = tuple(x.clone() for x in grads[name])
                call(name)
                torch.cuda.synchronize()
                err[name] = max(float((a.float() - w).abs().max()) / float(
                    w.abs().max()) for a, w in zip(grads[name], want))
                # chip_smoke.py's attention_grad gate, and a rerun
                # bit-identical
                tol = chip_smoke.ATTN_GRAD_REL_TOL
                ok[name] = all(
                    torch.equal(a, b) and bool(
                        ((a.float() - w).abs() <= tol * w.abs().max() + (
                            chip_smoke.bf16_ulp(torch, w.bfloat16().float()
                                                .abs())
                            if dt == "bfloat16" else 0.0)).all())
                    for a, b, w in zip(grads[name], first, want))
                del first
            del want
            iters = 200 if S <= 128 else 10
            turns, library = [], []
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    fn = (lambda name=name: call(name))
                    turns.append({"tree": name, "ms": events_ms(fn, iters),
                                  "device_ms": device_ms(fn, KERNEL,
                                                         iters // 4 or 1)})
                if not softcap:   # SDPA has no softcap
                    library.append({"ms": events_ms(sdpa, iters),
                                    "device_ms": device_ms(
                                        sdpa, None, iters // 4 or 1)})
            flops, nbytes = fa.backward_cost(q, k, causal, window)
            rate = (chip_smoke.BF16_TC_FLOPS_PER_S if dt == "bfloat16"
                    else chip_smoke.F32_FLOPS_PER_S)
            bms, by = chip_smoke.bound_ms(nbytes, flops, rate)
            results.append({
                "shape": {"B": B, "H": H, "KV": KV, "S": S, "T": S, "hd": hd,
                          **masks, "dtype": dt, "config": label},
                "max_err_rel_to_max": err, "within_gate": ok,
                "turns": turns, "sdpa_backward": library, "bound_ms": bms,
                "bound_by": by})
            del q, k, v, do, lse, grads, work, qh, kh, vh, oh, doh
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "shapes": results}))
    return 0 if all(all(r["within_gate"].values()) for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
