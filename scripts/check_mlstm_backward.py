#!/usr/bin/env python3
"""Check and time the mLSTM backward kernel on one card, launch by launch.

    python3 scripts/check_mlstm_backward.py

Builds the port's kernels (``kernels/build.py``), prints each mLSTM
backward function's registers and spills (ptxas) and tensor-core
instruction kinds (``cuobjdump -sass``), holds ``mlstm_chunkwise_bwd``
against autograd of the chunkwise plain version at shapes that take one
chunk and shapes that take the forward's (``backward_chunk``), from a
zero and a carried state, with and without the zero-state skip (each
gradient's max abs error over its largest, and whether a rerun is
bit-identical), and times it at three shapes: CUDA events over 50 calls
after 5, and the profiler's device time and count of each launch.  The
quick loop for work on ``csrc/mlstm_scan_bwd.cu``; ``chip_smoke.py``'s
``mlstm_grad`` and ``times`` phases are the checks of record.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, S, H, dh, carried state)
CHECKS = [(1, 40, 3, 16, False), (2, 96, 2, 32, True), (1, 97, 1, 8, True),
          (2, 128, 2, 256, False), (1, 200, 2, 64, True),
          (1, 1024, 2, 128, True), (1, 2048, 2, 256, False),
          (2, 512, 4, 1024, False)]
TIMES = [(2, 512, 4, 1024), (2, 128, 2, 256), (1, 2048, 2, 256)]


def inputs(torch, B, S, H, dh, carried, seed):
    """q, k, v, i, f and a state as ``chip_smoke.py`` draws them: forget
    gates biased by +3, a carried state small and random, else zeros."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    q, k, v = r(B, S, H, dh), r(B, S, H, dh), r(B, S, H, dh)
    i, f = r(B, S, H), r(B, S, H) + 3.0
    if carried:
        st = {"C": r(B, H, dh, dh) * 0.3, "n": r(B, H, dh) * 0.3,
              "m": r(B, H)}
    else:
        st = {"C": torch.zeros(B, H, dh, dh, device="cuda"),
              "n": torch.zeros(B, H, dh, device="cuda"),
              "m": torch.zeros(B, H, device="cuda")}
    return q, k, v, i, f, st


def sass_kinds(build, lib) -> dict:
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    out = {}
    for obj in sorted(build.objects_dir(lib.path).glob("mlstm_scan_bwd*.o")):
        text = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                              capture_output=True, text=True,
                              timeout=300).stdout
        fn = None
        for line in text.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif fn and ("HMMA" in line or "HGMMA" in line):
                op = "HGMMA" if "HGMMA" in line else "HMMA"
                kind = line[line.index(op):].split()[0]
                out.setdefault(fn, {}).setdefault(kind, 0)
                out[fn][kind] += 1
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_scan import ops as ml
    if not torch.cuda.is_available():
        print("check_mlstm_backward: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build.library()
    report = {"build_seconds": lib.build_seconds, "ptxas": {
        fn: info for fn, info in build.ptxas_summary(lib.ptxas_log).items()
        if "mlstm_bwd" in fn}, "sass": sass_kinds(build, lib),
        "checks": [], "times": []}
    for B, S, H, dh, carried in CHECKS:
        q, k, v, i, f, st = inputs(torch, B, S, H, dh, carried, dh)
        dh_ = torch.randn(B, S, H, dh, device="cuda")
        chunk = ml.backward_chunk(S, dh)
        h, _, states = ml._launch(q, k, v, i, f, st, chunk < S)
        want = ml.mlstm_chunkwise_grad_plain(q, k, v, i, f, st, dh_)
        for skip in ([False] if carried else [False, True]):
            got, again = (ml.mlstm_chunkwise_bwd(q, k, v, i, f, st, h, dh_,
                                                 states, zero_state=skip)
                          for _ in range(2))
            torch.cuda.synchronize()
            report["checks"].append({
                "B": B, "S": S, "H": H, "dh": dh, "carried_state": carried,
                "chunk": chunk, "zero_state_skip": skip,
                "err_rel_to_max": [float((a - w).abs().max()
                                         / w.abs().max())
                                   for a, w in zip(got, want)],
                "bit_identical_rerun": all(torch.equal(a, b)
                                           for a, b in zip(got, again))})
    for B, S, H, dh in TIMES:
        q, k, v, i, f, st = inputs(torch, B, S, H, dh, False, 3)
        dh_ = torch.randn(B, S, H, dh, device="cuda")
        chunk = ml.backward_chunk(S, dh)
        h, _, states = ml._launch(q, k, v, i, f, st, chunk < S)

        def call():
            ml.mlstm_chunkwise_bwd(q, k, v, i, f, st, h, dh_, states,
                                   zero_state=True)

        for _ in range(5):
            call()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(50):
            call()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        launches = {e.key.split("(")[0]: {
            "device_ms": e.self_device_time_total / 10 / 1e3,
            "per_call": e.count / 10}
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and "mlstm_bwd" in e.key}
        report["times"].append({"B": B, "S": S, "H": H, "dh": dh,
                                "chunk": chunk,
                                "ms": start.elapsed_time(end) / 50,
                                "launches": launches})
    report["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
