#!/usr/bin/env python3
"""Hold the sharded train, prefill and decode steps to the meshless ones
across cards: one NCCL rank a card.

    python3 scripts/sharded_steps_cards.py [--cases dense:1x2 gqa:1x4 ...]

Each case spawns one rank per device of its (data, model) mesh, rank r
on card r, over a ``FileStore`` in a temporary directory (no network),
and runs ``tests/torch_sharded_util.py``'s ``check_steps``, the checks
that ``tests/test_torch_sharded_step.py`` and
``tests/test_torch_sharded_recurrent.py`` run on gloo ranks on the CPU:
a tiny f32 model's sharded ``train_step`` (loss, both AdamW moments,
the weights), ``prefill_step`` (last logits, caches) and 4 greedy
``serve_step``s against the meshless steps on the same card, at the
file's tolerances, and the kernel launches of the sharded train step
and prefill equal to the meshless ones.  On the cards the attention and
mLSTM kernels run on each device's shards: the GQA case's replicated kv
heads (each card takes the kv head its query heads use, their gradient
a partial sum across cards) and the partial sums of a split
projection are the CUDA kernels' and NCCL's.  The kernels are built once
before the ranks start.  Prints one JSON object: the card's name and
power limit, and each case's mesh, result, launches and seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

CASES = ("dense:1x2", "dense:2x1", "dense:2x2", "gqa:1x4", "moe:1x4",
         "mamba:2x2", "xlstm:1x4")


def worker(rank: int, world: int, store: str, shape, case: str,
           report: str):
    import torch.distributed as dist

    import torch_sharded_util as util
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=180))
    try:
        counts = util.check_steps(shape, case, f"cuda:{rank}")
        if rank == 0:
            Path(report).write_text(json.dumps(counts))
    finally:
        dist.destroy_process_group()


def run_case(spec: str) -> dict:
    import torch.multiprocessing as mp

    case, dims = spec.split(":")
    shape = tuple(int(n) for n in dims.split("x"))
    world = shape[0] * shape[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "launches.json")
        try:
            mp.spawn(worker, args=(world, os.path.join(tmp, "store"), shape,
                                   case, report), nprocs=world, join=True)
            out = {"ok": True,
                   "launches": json.loads(Path(report).read_text())}
        except Exception:
            out = {"ok": False, "error": traceback.format_exc()[-3000:]}
    return {"case": case, "mesh": list(shape), **out,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import torch

    from repro_torch.kernels import build
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES))
    args = ap.parse_args(argv)
    need = max(int(d) * int(m) for d, m in
               (c.split(":")[1].split("x") for c in args.cases))
    if torch.cuda.device_count() < need:
        raise SystemExit(f"needs {need} cards, sees "
                         f"{torch.cuda.device_count()}")
    build.library()
    results = [run_case(c) for c in args.cases]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "cases": results}))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
