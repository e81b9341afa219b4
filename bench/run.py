"""The benchmark of the PyTorch port: one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the repository's root.  The cell is a ``workloads`` entry of
``BENCHMARK.json``; ``harness/core.py`` says which files it is made of.
Set-up (imports, weights drawn on the card from the seed, the system
built and every shape the cell uses warmed) counts as ``setup_s``; the
window then measures for ``--seconds``.  With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a profiler trace of part of the window and from the
system's counters.  Either way the answers are checked against the
plain reference after the window, and each compared number is printed
beside its limit.

The last line of standard output is the result, one JSON object.  The
run exits with another code than 0, and prints no result, without a
CUDA device (or with fewer than the cell asks for), and when the JAX
package or JAX itself is loaded once the window has closed.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]
os.environ.setdefault("USE_FLAX", "0")

from harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    spec = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
    cell = core.Cell(spec, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 2
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_PROCESS)
    found = core.forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("\n".join(core.check_lines(result)), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
