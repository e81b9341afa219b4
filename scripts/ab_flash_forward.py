#!/usr/bin/env python3
"""Time the port's attention forward kernel against another tree's, in
one process on one card.

    python3 scripts/ab_flash_forward.py OTHER_TREE [--rounds N]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` (with
``flash_attention_bf16.cu`` where the tree has it) of this checkout and
of ``OTHER_TREE`` (for example the parent commit, unpacked
with ``git archive``) with the flags of ``kernels/build.py``, loads both
with ctypes, and times the serving forward (no log-sum-exp written) at
the router's shape (B, S, H, hd) = (32, 128, 4, 32), non-causal, in
turns: other, this, this, other, for ``--rounds`` rounds.  Each turn
reports CUDA-event time over 200 launches after 20 warm-up launches and
the profiler's device time per launch.  Prints one JSON object with the
card's name and power limit.
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
SHAPE = (32, 128, 4, 32)


def build(tree: Path, out: Path) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    csrc = tree / "src/repro_torch/kernels/csrc"
    src = csrc / "flash_attention.cu"
    # a tree with bf16 inputs builds their instances in a second source
    srcs = [str(p) for p in (src, csrc / "flash_attention_bf16.cu")
            if p.exists()]
    subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-shared",
                    "-o", str(out), *srcs], check=True,
                   capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    fn = lib.tryage_flash_attention
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # a tree whose forward writes the log-sum-exp takes one more pointer,
    # and one that takes bf16 inputs a type flag after the scale
    text = src.read_text()
    with_lse = "float* lse" in text
    lib.with_dtype = "int bf16" in text
    fn.argtypes = ([P] * (5 if with_lse else 4) + [I] * 8 + [F] * 2
                   + [I] * lib.with_dtype + [P])
    fn.restype = ctypes.c_int
    lib.with_lse = with_lse
    return lib


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_flash_forward: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build(args.other.resolve(), Path(tmp) / "o.so"),
                "this": build(ROOT, Path(tmp) / "t.so")}
        B, S, H, hd = SHAPE
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, H, hd, device="cuda", generator=g)
                   for _ in range(3))
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib):
            ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
            if lib.with_lse:
                ptrs.append(None)
            flags = [0] * lib.with_dtype     # f32 inputs
            err = lib.tryage_flash_attention(*ptrs, B, S, S, H, H, hd, 0, 0,
                                             0.0, hd ** -0.5, *flags, stream)
            if err:
                raise RuntimeError(f"launch error {err}")

        def events_ms(lib, iters=200):
            for _ in range(20):
                call(lib)
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            for _ in range(iters):
                call(lib)
            e.record()
            torch.cuda.synchronize()
            return s.elapsed_time(e) / iters

        def device_ms(lib, iters=50):
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    call(lib)
                torch.cuda.synchronize()
            t = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if "flash_attention_kernel" in ev.key)
            return t / iters / 1e3 or None

        outs = {}
        for name in libs:
            call(libs[name])
            torch.cuda.synchronize()
            outs[name] = o.clone()
        turns = []
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                turns.append({"tree": name, "ms": events_ms(libs[name]),
                              "device_ms": device_ms(libs[name])})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"shape": dict(zip(("B", "S", "H", "hd"), SHAPE)),
                      "card": smi,
                      "same_output": bool(torch.equal(outs["this"],
                                                      outs["other"])),
                      "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
