#!/usr/bin/env python3
"""Time the port's small kernel calls through their wrappers against
another tree's, on one card.

    python3 scripts/ab_wrapper_overhead.py OTHER_TREE [--rounds N]

The router heads and the router encoder's attention are host-bound: a
call's time is mostly the wrapper's Python and the launch.  This script
times ``router_score_fused``, ``router_score_cascade_fused`` (B 32, d =
hh = 128, 11 experts, 2 constraints) and ``flash_attention`` (32, 128,
4, 32, f32, bidirectional), the main path's shapes, each with CUDA
events over 200 back-to-back calls after 20 warm-up calls (as
``chip_smoke.py``'s ``times``), in one process per turn, turns in the
order other, this, this, other for ``--rounds`` rounds, and the time
of a failed ``os.stat`` on the host.  Each tree builds its own kernels
into its own ``build/``.  Prints one JSON object
with every turn's times and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = r"""
import json, torch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.router_cascade import ops as rc
from repro_torch.kernels.router_score import ops as rs
g = torch.Generator(device="cuda").manual_seed(0)
r = lambda *s: torch.randn(*s, device="cuda", generator=g)
B, d, hh, M, n_c = 32, 128, 128, 11, 2
head = [r(B, d), r(d, hh) * d ** -0.5, r(hh), r(hh, M) * hh ** -0.5, r(M)]
unc = [r(d, hh) * d ** -0.5, r(hh), r(hh, M) * hh ** -0.5, r(M)]
cv, lam = r(n_c, M).abs(), r(B, n_c).abs()
pos = torch.randperm(M, device="cuda", generator=g).to(torch.int32)
q, k, v = (r(32, 128, 4, 32) for _ in range(3))
calls = {"router_score": lambda: rs.router_score_fused(*head, cv, lam),
         "router_cascade": lambda: rc.router_score_cascade_fused(
             *head, *unc, cv, lam, pos),
         "flash_attention": lambda: fa.flash_attention(q, k, v,
                                                       causal=False)}


def events_ms(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


out = {n: events_ms(f) for n, f in calls.items()}
# a failed os.stat of a relative path, what a table consult did on every
# call before it kept its answer for a second
import os, time
t0 = time.perf_counter()
for _ in range(1000):
    try:
        os.stat("experiments/tryage/no_table.json")
    except OSError:
        pass
out["failed_stat_us"] = (time.perf_counter() - t0) * 1e3
print(json.dumps(out))
"""


def turn(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    out = subprocess.run([sys.executable, "-c", TURN], env=env, cwd=tree,
                         capture_output=True, text=True, timeout=1200)
    if out.returncode:
        raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": ROOT}
    turns = []
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            turns.append({"tree": name, "ms": turn(trees[name])})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "turns": turns,
                      "method": "CUDA events over 200 calls after 20, one "
                                "process a turn"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
