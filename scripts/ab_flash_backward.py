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
in turns: other, this, this, other, for ``--rounds`` rounds.  Each turn
reports CUDA-event time over 200 launches after 20 warm-up launches and
the profiler's device time per call (all of a call's launches).  SDPA's
backward (``torch.autograd.grad`` through
``scaled_dot_product_attention``) is timed the same way in each round,
as the library yardstick.  Both trees get the same inputs and the same
log-sum-exp (computed in f32 by PyTorch); the gradients of each are
held against autograd of the plain version.  Prints one JSON object with
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


def build(tree: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    csrc = tree / "src/repro_torch/kernels/csrc"
    src = csrc / "flash_attention_bwd.cu"
    units = [(src, ())]
    if (csrc / "flash_attention_bwd_part.cu").exists():
        units += [(csrc / "flash_attention_bwd_part.cu", d)
                  for d in kbuild.PARTS["flash_attention_bwd_part.cu"]]
    procs = [subprocess.Popen(
        [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, *d, "-c", str(u), "-o",
         f"{out}.{i}.o"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, (u, d) in enumerate(units)]
    for p in procs:
        if p.wait(timeout=900):
            raise RuntimeError(p.stdout.read().decode())
    subprocess.run([kbuild.nvcc_path(), *kbuild.ARCH, "-shared", "-o",
                    str(out), *(f"{out}.{i}.o" for i in range(len(units)))],
                   check=True, capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(str(out))
    fn = lib.tryage_flash_attention_bwd
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = src.read_text()
    # a tree with two launches at every shape takes two (B, H, S)
    # workspaces; later designs one (B, H, S, 2), read past 128 keys
    # only; since bf16 came in, an int says the inputs' type
    lib.two_workspaces = "float* dsum, float* lse_b" in text
    lib.dtype_flag = "int bf16, void* stream" in text
    fn.argtypes = ([P] * 5 + [P] * (5 if lib.two_workspaces else 4)
                   + [I] * 8 + [F] * 2 + [I] * lib.dtype_flag + [P])
    fn.restype = ctypes.c_int
    return lib


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
        for _ in range(20):
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
        libs = {"other": build(args.other.resolve(), Path(tmp) / "o.so"),
                "this": build(ROOT, Path(tmp) / "t.so")}
        for B, H, S, hd in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(hd)
            q, k, v, do = (torch.randn(B, S, H, hd, device="cuda",
                                       generator=g) for _ in range(4))
            scale = 1.0 / math.sqrt(hd)
            lse = torch.logsumexp(torch.einsum("bshd,bthd->bhst", q * scale,
                                               k), dim=-1).contiguous()
            grads = {n: tuple(torch.empty_like(x) for x in (q, k, v))
                     for n in libs}
            work = torch.empty(2, B, H, S, device="cuda")

            def call(name):
                lib, (dq, dk, dv) = libs[name], grads[name]
                ws = ([work[0].data_ptr(), work[1].data_ptr()]
                      if lib.two_workspaces else [None])
                err = lib.tryage_flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), *ws, dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B, S, S, H, H, hd, 0, 0, 0.0, scale,
                    *([0] if lib.dtype_flag else []), stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")

            qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_(True)
                          for a in (q, k, v))
            with torch.enable_grad():
                oh = F.scaled_dot_product_attention(qh, kh, vh)
            doh = do.transpose(1, 2).contiguous()

            def sdpa():
                return torch.autograd.grad(oh, (qh, kh, vh), doh,
                                           retain_graph=True)

            want = fa.attention_grad_plain(q, k, v, do, causal=False)
            err = {}
            for name in libs:
                call(name)
                torch.cuda.synchronize()
                err[name] = max(float((a - w).abs().max()) / float(
                    w.abs().max()) for a, w in zip(grads[name], want))
            turns, library = [], []
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    fn = (lambda name=name: call(name))
                    turns.append({"tree": name, "ms": events_ms(fn),
                                  "device_ms": device_ms(fn, KERNEL)})
                library.append({"ms": events_ms(sdpa),
                                "device_ms": device_ms(sdpa)})
            results.append({
                "shape": {"B": B, "H": H, "S": S, "T": S, "hd": hd},
                "max_err_rel_to_max": err, "turns": turns,
                "sdpa_backward": library})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "shapes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
