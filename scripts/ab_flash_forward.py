#!/usr/bin/env python3
"""Time the port's attention forward kernel against another tree's, in
one process on one card.

    python3 scripts/ab_flash_forward.py OTHER_TREE [--rounds N]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` (with
``flash_attention_bf16.cu`` where the tree has it) of this checkout and
of ``OTHER_TREE`` (for example the parent commit, unpacked
with ``git archive``) with the flags of ``kernels/build.py``, every
source of both trees in its own nvcc process, side by side; loads both
with ctypes, and times the serving forward (no log-sum-exp written) at
the router's f32 shape (B, S, H, hd) = (32, 128, 4, 32), non-causal,
and at the zoo decoders' bf16 prefill shapes (``chip_smoke.py``'s
``ZOO_TIMES``: GQA, causal, window and softcap as each config has
them), in turns: other, this, this, other, for ``--rounds`` rounds.
Each turn reports CUDA-event time (200 launches after 20 warm-up
launches at the router's shape, 20 after 3 at the zoo's) and the
profiler's device time per launch; SDPA
(``scaled_dot_product_attention`` on the same bf16 inputs and mask, K/V
repeated to H heads and transposed beforehand; without the softcap,
which it does not compute) is timed the same way in each round, as the
library yardstick, and the bound is the larger of the bytes (q, k, v
read, o written) over 3.35 TB/s and the pairs the masks leave at 4 hd
operations a head over the bf16 tensor cores' 989 TFLOP/s (f32: the
f32 CUDA cores' 67 TFLOP/s).  Each tree's output is held against the
plain version: f32 within ``ATTN_TOL``, bf16 within one bf16 ulp plus
``ATTN_TOL`` (``chip_smoke.py``'s parity gate).  Prints one JSON object
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUTER_SHAPE = (32, 128, 4, 32)
KERNEL = "flash_attention_kernel"   # in every device function's name


def build(tree: Path, out: Path) -> list:
    """Start nvcc on each forward source of ``tree``; ``load`` links."""
    from repro_torch.kernels import build as kbuild
    csrc = tree / "src/repro_torch/kernels/csrc"
    # a tree with bf16 inputs builds their instances in a second source
    srcs = [p for p in (csrc / "flash_attention.cu",
                        csrc / "flash_attention_bf16.cu") if p.exists()]
    return [(subprocess.Popen(
        [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-c", str(src), "-o",
         f"{out}.{i}.o"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        f"{out}.{i}.o") for i, src in enumerate(srcs)]


def load(tree: Path, out: Path, procs: list) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    for p, _ in procs:
        if p.wait(timeout=900):
            raise RuntimeError(p.stdout.read().decode())
    subprocess.run([kbuild.nvcc_path(), *kbuild.ARCH, "-shared", "-o",
                    str(out), *(o for _, o in procs)], check=True,
                   capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(str(out))
    fn = lib.tryage_flash_attention
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # a tree whose forward writes the log-sum-exp takes one more pointer,
    # one that takes bf16 inputs a type flag after the scale, and one
    # with a choice of warps that after the flag
    text = (tree / "src/repro_torch/kernels/csrc/flash_attention.cu"
            ).read_text()
    lib.with_lse = "float* lse" in text
    lib.with_dtype = "int bf16" in text
    lib.with_warps = "int warps, void* stream" in text
    fn.argtypes = ([P] * (5 if lib.with_lse else 4) + [I] * 8 + [F] * 2
                   + [I] * (lib.with_dtype + lib.with_warps) + [P])
    fn.restype = ctypes.c_int
    return lib


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from repro_torch.kernels.flash_attention import ops as fa
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_flash_forward: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream

    def events_ms(fn, iters, warmup):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def device_ms(fn, match, iters):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        t = sum(ev.self_device_time_total for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA")
                and (match is None or match in ev.key))
        return t / iters / 1e3 or None

    B, S, H, hd = ROUTER_SHAPE
    cases = [(B, S, H, H, hd, False, 0, 0.0, "float32", "router")]
    cases += [(*c[:8], "bfloat16", c[8]) for c in chip_smoke.ZOO_TIMES]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        trees = {"other": args.other.resolve(), "this": ROOT}
        procs = {n: build(t, Path(tmp) / f"{n}.so") for n, t in trees.items()}
        libs = {n: load(trees[n], Path(tmp) / f"{n}.so", procs[n])
                for n in trees}
        for B, S, H, KV, hd, causal, window, softcap, dt, label in cases:
            dtype = getattr(torch, dt)
            g = torch.Generator(device="cuda").manual_seed(S + hd)
            q = torch.randn(B, S, H, hd, device="cuda", generator=g).to(dtype)
            k, v = (torch.randn(B, S, KV, hd, device="cuda", generator=g)
                    .to(dtype) for _ in range(2))
            outs = {n: torch.empty_like(q) for n in libs}

            def call(name):
                lib, o = libs[name], outs[name]
                ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr()] + [None] * lib.with_lse
                flags = ([int(dt == "bfloat16")] * lib.with_dtype
                         + [0] * lib.with_warps)
                err = lib.tryage_flash_attention(
                    *ptrs, B, S, S, H, KV, hd, int(causal), window, softcap,
                    hd ** -0.5, *flags, stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")

            masks = dict(causal=causal, window=window, softcap=softcap)
            ref = fa.attention_plain(q, k, v, **masks).float()
            err = {}
            for name in libs:
                call(name)
                torch.cuda.synchronize()
                diff = (outs[name].float() - ref).abs()
                e = {"max_abs_err": float(diff.max())}
                if dt == "bfloat16":
                    ulp = chip_smoke.bf16_ulp(torch, torch.maximum(
                        outs[name].float().abs(), ref.abs()))
                    e["ulps_past_tol"] = float(
                        ((diff - chip_smoke.ATTN_TOL).clamp_min(0) / ulp)
                        .max())
                    e["ok"] = e["ulps_past_tol"] <= 1.0
                else:
                    e["ok"] = e["max_abs_err"] <= chip_smoke.ATTN_TOL
                err[name] = e
            same = bool(torch.equal(outs["this"], outs["other"]))
            del ref
            qh = q.transpose(1, 2).contiguous()
            kh, vh = (a.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                      .contiguous() for a in (k, v))
            mask = None
            if window > 0:
                i = torch.arange(S, device="cuda")
                mask = ((i[None, :] <= i[:, None]) if causal else True) & (
                    i[None, :] > i[:, None] - window)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask,
                    is_causal=causal and mask is None)

            iters, warm = (200, 20) if S <= 128 else (20, 3)
            turns, library = [], []
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    fn = (lambda name=name: call(name))
                    turns.append({"tree": name,
                                  "ms": events_ms(fn, iters, warm),
                                  "device_ms": device_ms(fn, KERNEL,
                                                         iters // 2)})
                if dt == "bfloat16":
                    library.append({"ms": events_ms(sdpa, iters, warm),
                                    "device_ms": device_ms(sdpa, None,
                                                           iters // 2)})
            flops, nbytes = fa.forward_cost(q, k, causal, window)
            rate = (chip_smoke.BF16_TC_FLOPS_PER_S if dt == "bfloat16"
                    else chip_smoke.F32_FLOPS_PER_S)
            bms, by = chip_smoke.bound_ms(nbytes, flops, rate)
            results.append({
                "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                          **masks, "dtype": dt, "config": label},
                "errors": err, "same_output": same, "turns": turns,
                "sdpa": library, "bound_ms": bms, "bound_by": by})
            del q, k, v, qh, kh, vh, outs
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "shapes": results}))
    return 0 if all(e["ok"] for r in results
                    for e in r["errors"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
