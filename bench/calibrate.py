"""The readings that the limits of ``bench/limits/<workload>.json`` are set
from, for one cell, in one process:

    python3 bench/calibrate.py --workload <name> --seeds 1-12 \
        --control-seeds 1-3 --seconds <s> --out <file.json>

For each seed of ``--seeds`` it sets the cell up, serves a window of
``--seconds`` at the cell's own load and size, and reads every compared
number of the program's answers (the lower readings).  For each seed of
``--control-seeds`` it also reads the control's: the plain reference at
the precision below the configuration's (float32 -> TF32, bfloat16 ->
fp8), put in the program's place over the same requests (the upper
readings).  The benchmark's own runs never run the control.  Needs the
card; writes the readings as JSON to ``--out`` and prints them.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

from harness import core  # noqa: E402
from harness.checks import CONTROL  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    spec = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    cell = core.Cell(spec, args.workload)
    control = CONTROL[cell.cfg["dtype"]]
    ctl_seeds = set(seeds(args.control_seeds)) if args.control_seeds else set()
    rows = []
    for seed in seeds(args.seeds):
        t0 = time.monotonic()
        run = cell.system.Run(cell.cfg, cell.mix, cell.ref, cell.adapter,
                              seed, torch.device("cuda:0"))
        run.setup()
        e2e = run.window(args.seconds)
        run.release()
        gc.collect()
        torch.cuda.empty_cache()
        row = {"seed": seed, "program": run.check(), "e2e": e2e,
               "attempted": run.attempted, "notes": run.notes}
        if seed in ctl_seeds:
            row["control"] = run.check(control=control)
            row["control_mode"] = control
        row["seconds"] = time.monotonic() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    out = {"workload": args.workload, "limits": cell.limits,
           "device": torch.cuda.get_device_name(0), "rows": rows}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
