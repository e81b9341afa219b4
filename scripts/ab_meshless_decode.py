#!/usr/bin/env python3
"""Time the port's meshless zoo prefill and decode steps against another
tree's, on one card.

    python3 scripts/ab_meshless_decode.py OTHER_TREE [--rounds N]

Decode is host-bound: a step's time is mostly the model code's Python
and the launches, so a change to the model layer that only costs host
work shows here first.  Each turn draws tinyllama-1.1b (4 x 512) and
gemma3-4b (2 x 2048: ring caches and a global cache) at full width in
bf16 from a seed on the card, and times, with the host clock around a
synchronize, ``prefill_step`` (one warm-up, then 3) and 4 blocks of 32
greedy ``serve_step``s from the prefill's cache after a warm-up block,
meshless, as ``chip_smoke.py``'s ``zoo_serve`` does.  One process a
turn, turns in the order other, this, this, other for ``--rounds``
rounds; each tree builds its own
kernels into its own ``build/``.  Prints one JSON object with every
turn's times (ms: prefill median; decode a step: mean, median, the
fastest step and the fastest block's mean) and the card's name and
power limit.  The host's share of a turn moves between turns; the
fastest step and block are the least moved by it.
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
import json, statistics, time, torch
from repro_torch.configs import get_config
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models import model as model_lib

BLOCKS = 4
out = {}
for arch, B, S, steps in (("tinyllama-1.1b", 4, 512, 32),
                          ("gemma3-4b", 2, 2048, 32)):
    cfg = get_config(arch)
    model = model_lib.init_model(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                                     generator=g, dtype=torch.int32)}
    cap = S + steps + 1
    pre = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, state = prefill_step(model, batch, cache_capacity=cap)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    first = last.argmax(-1).to(torch.int32)[:, None]
    blocks = []
    for b in range(BLOCKS + 1):           # the first block warms up
        tok, st = serve_step(model, state, first, S)
        dec = []
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, st = serve_step(model, st, tok, S + 1 + t)
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3)
        blocks.append(dec)
    dec = [x for blk in blocks[1:] for x in blk]
    out[arch] = {"prefill_ms": statistics.median(pre[1:]),
                 "decode_ms_mean": statistics.mean(dec),
                 "decode_ms_median": statistics.median(dec),
                 "decode_ms_min": min(dec),
                 "decode_ms_best_block": min(statistics.mean(blk)
                                             for blk in blocks[1:]),
                 "finite": bool(torch.isfinite(last).all())}
    del model, state, st, last
    torch.cuda.empty_cache()
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
    ap.add_argument("--rounds", type=int, default=1)
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
                      "method": "host clock around a synchronize; prefill "
                                "median of 3 after one, decode over 4 "
                                "blocks of 32 steps after one block; one "
                                "process a turn"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
