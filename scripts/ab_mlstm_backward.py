#!/usr/bin/env python3
"""Time the port's mLSTM backward kernel against another tree's, in one
process on one card.

    python3 scripts/ab_mlstm_backward.py OTHER_TREE [--rounds N]

Builds ``src/repro_torch/kernels/csrc/mlstm_scan.cu`` and
``mlstm_scan_bwd.cu`` of this checkout and of ``OTHER_TREE`` (for example
the parent commit, unpacked with ``git archive``) with the flags of
``kernels/build.py``, all nvcc processes side by side, loads both with
ctypes, and times them at (B, S, H, dh) = (2, 512, 4, 1024) (xlstm-1.3b's
training shape) and (2, 128, 2, 256) (its reduced config's), from a zero
state, in turns: other, this, this, other, for ``--rounds`` rounds.
Each tree runs as its training step does: its forward (with the
chunk-start states where its backward reads them) and its backward (at
its own chunk; this tree's told that the state is zero where it takes
that flag).  Each turn reports CUDA-event time over 50 calls after 5
warm-up calls and the profiler's device time per call, for the backward
and for the forward.  Both trees get the same inputs; the gradients of
each are held against autograd of the chunkwise plain version.  Prints
one JSON object with the card's name and power limit.
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
SHAPES = ((2, 512, 4, 1024), (2, 128, 2, 256))
SOURCES = ("mlstm_scan.cu", "mlstm_scan_bwd.cu")


def build(tree: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    csrc = tree / "src/repro_torch/kernels/csrc"
    procs = [subprocess.Popen(
        [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-c", str(csrc / src), "-o",
         f"{out}.{i}.o"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, src in enumerate(SOURCES)]
    for p in procs:
        if p.wait(timeout=900):
            raise RuntimeError(p.stdout.read().decode())
    subprocess.run([kbuild.nvcc_path(), *kbuild.ARCH, "-shared", "-o",
                    str(out), *(f"{out}.{i}.o" for i in range(len(SOURCES)))],
                   check=True, capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # since the backward took its own chunk, the forward also writes m at
    # each chunk's start, and the backward reads it and a zero-state flag
    lib.mst = "float* mst" in (csrc / "mlstm_scan.cu").read_text()
    lib.zero_flag = "int zero_state" in (csrc / "mlstm_scan_bwd.cu").read_text()
    lib.tryage_mlstm_scan.argtypes = ([P] * 8 + [P] * (7 + lib.mst)
                                      + [I] * 5 + [F] + [P])
    lib.tryage_mlstm_scan_bwd.argtypes = ([P] * (10 + lib.mst) + [P] * 6
                                          + [I] * (5 + lib.zero_flag)
                                          + [F] + [P])
    for fn in ("tryage_mlstm_scan", "tryage_mlstm_scan_bwd"):
        getattr(lib, fn).restype = ctypes.c_int
    lib.tryage_mlstm_scan_workspace.argtypes = [I] * 4
    lib.tryage_mlstm_scan_bwd_workspace.argtypes = [I] * 5
    lib.tryage_mlstm_scan_workspace.restype = ctypes.c_longlong
    lib.tryage_mlstm_scan_bwd_workspace.restype = ctypes.c_longlong
    return lib


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels.mlstm_scan import ops as ml
    from repro_torch.models.scan_utils import pick_chunk
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_mlstm_backward: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream

    def events_ms(fn, iters=50):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def device_ms(fn, match, iters=20):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA") and match(ev.key)]
        t = sum(ev.self_device_time_total for ev in evs)
        return (t / iters / 1e3 or None,
                sum(ev.count for ev in evs) / iters or None)

    results = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build(args.other.resolve(), Path(tmp) / "o.so"),
                "this": build(ROOT, Path(tmp) / "t.so")}
        for B, S, H, dh in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(dh)
            r = lambda *s: torch.randn(*s, device="cuda", generator=g)
            q, k, v, dh_ = r(B, S, H, dh), r(B, S, H, dh), r(B, S, H, dh), \
                r(B, S, H, dh)
            i_pre, f_pre = r(B, S, H), r(B, S, H) + 3.0
            C0 = torch.zeros(B, H, dh, dh, device="cuda")
            n0 = torch.zeros(B, H, dh, device="cuda")
            m0 = torch.zeros(B, H, device="cuda")
            scale = 1.0 / math.sqrt(dh)
            Lf = pick_chunk(S, ml.MAX_CHUNK)
            runs = {}
            for name, lib in libs.items():
                Lb = (ml.backward_chunk(S, dh) if lib.zero_flag else Lf)
                keep = Lb < S
                nc = S // Lf
                h = torch.empty_like(q)
                out = [torch.empty_like(t) for t in (C0, n0, m0)]
                fwork = torch.empty(lib.tryage_mlstm_scan_workspace(
                    B, S, H, Lf), device="cuda")
                states = ([torch.empty(B, H, nc, dh, dh, device="cuda"),
                           torch.empty(B, H, nc, dh, device="cuda"),
                           torch.empty(B, H, nc, device="cuda")]
                          if keep else [])
                fptrs = [t.data_ptr() for t in states[:2 + lib.mst]]
                if not keep:
                    fptrs = [None] * (2 + lib.mst)
                bstates = (states if keep else [C0, n0, m0])[:2 + lib.mst]
                grads = [torch.empty_like(t) for t in (q, k, v, i_pre, f_pre)]
                bwork = torch.empty(lib.tryage_mlstm_scan_bwd_workspace(
                    B, S, H, dh, Lb), device="cuda")

                def fwd(lib=lib, h=h, out=out, fwork=fwork, fptrs=fptrs):
                    err = lib.tryage_mlstm_scan(
                        *(t.data_ptr() for t in (q, k, v, i_pre, f_pre, C0,
                                                 n0, m0, h, *out, fwork)),
                        *fptrs, B, S, H, dh, Lf, scale, stream)
                    if err:
                        raise RuntimeError(f"forward: launch error {err}")

                def bwd(lib=lib, h=h, bstates=bstates, grads=grads,
                        bwork=bwork, Lb=Lb):
                    err = lib.tryage_mlstm_scan_bwd(
                        *(t.data_ptr() for t in (q, k, v, i_pre, f_pre, m0,
                                                 *bstates, h, dh_, *grads,
                                                 bwork)),
                        B, S, H, dh, Lb, *([1] if lib.zero_flag else []),
                        scale, stream)
                    if err:
                        raise RuntimeError(f"backward: launch error {err}")

                fwd()
                bwd()
                runs[name] = (fwd, bwd, grads, Lb, keep)
            torch.cuda.synchronize()
            want = ml.mlstm_chunkwise_grad_plain(
                q, k, v, i_pre, f_pre, {"C": C0, "n": n0, "m": m0}, dh_)
            err = {n: max(float((a - w).abs().max()) / float(w.abs().max())
                          for a, w in zip(run[2], want))
                   for n, run in runs.items()}
            turns = []
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    fwd, bwd = runs[name][:2]
                    bms, blaunch = device_ms(bwd, lambda n: "mlstm_bwd" in n)
                    fms, _ = device_ms(fwd, lambda n: "mlstm_scan" in n)
                    turns.append({"tree": name, "bwd_ms": events_ms(bwd),
                                  "bwd_device_ms": bms,
                                  "bwd_launches": blaunch,
                                  "fwd_ms": events_ms(fwd),
                                  "fwd_device_ms": fms})
            results.append({
                "shape": {"B": B, "S": S, "H": H, "dh": dh},
                "chunk": {n: run[3] for n, run in runs.items()},
                "forward_writes_states": {n: run[4] for n, run in runs.items()},
                "max_err_rel_to_max": err, "turns": turns})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "shapes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
