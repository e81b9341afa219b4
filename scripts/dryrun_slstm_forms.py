#!/usr/bin/env python3
"""What the sLSTM's chunked scan saves, by the dry run: one pair traced
on the meta device twice, with the sLSTM as the port runs it
(``models.ssm._slstm_scan``: chunks of 128 steps, each chunk's loop
checkpointed under autograd, the recurrent weights laid out once) and
as one loop over every step (``_slstm_per_step``: the recurrent
product an einsum each step, ``r_h`` laid out afresh and saved every
step, nothing checkpointed: the form the chunked scan replaced).
Both loops are counted by trip count, so a 4,096-step pair traces in
minutes.

    PYTHONPATH=src python3 scripts/dryrun_slstm_forms.py \\
        [--arch xlstm-1.3b] [--shape train_4k] [--mesh pod|multipod]

Prints one JSON line a form: temporary and peak bytes per device, dot
FLOPs, ops, the loops counted and the trace's seconds.  Needs no card.
"""

import argparse
import json
import time

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import ssm
from repro_torch.models.common import INPUT_SHAPES


def trace(arch: str, shape: str, mesh: str | None) -> dict:
    knobs, _ = dryrun.knobs_for(arch, shape, mesh)
    cfg = get_config(arch)
    t0 = time.perf_counter()
    if mesh is None:
        traced = dryrun.trace_step(cfg, INPUT_SHAPES[shape], knobs)
    else:
        traced, _ = dryrun._trace_on_mesh(cfg, INPUT_SHAPES[shape], knobs,
                                          mesh)
    mem, cost = traced["memory"], traced["cost"]
    return {"temp_bytes": mem["temp_bytes"],
            "peak_bytes_per_device": mem["peak_bytes_per_device"],
            "dot_flops": cost["dot_flops"], "n_ops": cost["n_ops"],
            "loops": cost["loops"], "trace_s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default=None, choices=sorted(dryrun.MESHES))
    args = ap.parse_args()
    chunked = ssm._slstm_scan
    for form, fn in (("chunked_scan", chunked),
                     ("per_step_loop", ssm._slstm_per_step)):
        ssm._slstm_scan = fn
        try:
            rec = trace(args.arch, args.shape, args.mesh)
        finally:
            ssm._slstm_scan = chunked
        print(json.dumps({"form": form, "arch": args.arch,
                          "shape": args.shape, "mesh": args.mesh, **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
