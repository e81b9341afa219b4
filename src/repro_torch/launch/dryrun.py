"""One-card dry run: judge each (arch x shape) pair without running a
model, and count its step's work (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each pair on a 512-device host mesh
and reads XLA's memory and cost analyses.  The port has no compiler to
ask: it traces the step that ``launch.steps`` runs (``train_step``,
``prefill_step`` or ``serve_step``, as the reference's ``build_step``
picks it) on the ``meta`` device, where tensors have shapes and types
and no storage, so no weight is allocated and nothing is launched, under
``launch.op_costs.OpCounter``.  Each record holds:

  * ``memory``: argument bytes (``parameter_bytes``, the AdamW
    moments' ``optimizer_bytes``, ``input_bytes``, ``cache_bytes``),
    output bytes (what the step returns), temporary bytes (the peak of
    live storages the step creates, as the counter follows them),
    ``peak_bytes_per_device`` (arguments + temporaries) and
    ``fits_one_card`` against the card's memory (the H100 preset's 80
    GB without a card);
  * ``cost``: the counter's totals (dot FLOPs and traffic with each
    hand-written kernel's recorded work, the aten op histogram);
  * ``roofline``: those totals under the ``h100`` preset (NVIDIA's
    data-sheet peaks);
  * ``model_flops`` (6 N D for a train step, 2 N D for prefill, 2 N B
    for decode) and ``active_params``;
  * ``status`` (``OK``, ``SKIP`` with the reason ``launch.specs``
    gives, or ``FAIL`` with ``error`` and ``trace``) and ``trace_s``,
    the seconds the trace took.

``knobs_for`` keeps the reference's per-pair knobs that mean something
on one card (``microbatch``, ``unit_group``); ``moment_dtype`` is
``float32`` (``train_step`` refuses bf16 moments) and
``rule_overrides`` has no meaning without a mesh: each knob dropped is
written into the record with the reference's value.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Runs on any host: the meta device needs no card.  Records go to
``experiments/dryrun_torch/`` (``--out``).
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import specs, steps
from repro_torch.launch.op_costs import OpCounter
from repro_torch.launch.roofline import (PRESETS, Roofline, active_params,
                                         model_flops)
from repro_torch.launch.steps import PerfKnobs
from repro_torch.models import model as model_lib
from repro_torch.models.common import INPUT_SHAPES, InputShape
from repro_torch.optim.adamw import adamw_init

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
HW = PRESETS["h100"]
META = torch.device("meta")

# The reference's per-pair knobs (src/repro/launch/dryrun.py:31-84):
# (arch, shape) -> {knob: value}.  rule_overrides and bf16 moments are
# the knobs dropped here.
_RULES_KV = {"cache": None, "embed": None}
REFERENCE_KNOBS = {
    ("jamba-v0.1-52b", "decode_32k"): {"rule_overrides": {
        "embed": None, "mlp": ("model", "data"),
        "heads": ("model", "data"), "kv_heads": ("model", "data"),
        "inner": ("model", "data"), "vocab": ("model", "data"),
        "capacity": None}},
    ("qwen1.5-0.5b", "decode_32k"): {"rule_overrides": _RULES_KV},
    ("qwen2-moe-a2.7b", "decode_32k"): {"rule_overrides": _RULES_KV},
    ("qwen2-vl-72b", "train_4k"): {"microbatch": 8,
                                   "moment_dtype": "bfloat16",
                                   "unit_group": 4},
    ("grok-1-314b", "train_4k"): {"microbatch": 8,
                                  "moment_dtype": "bfloat16",
                                  "unit_group": 4},
    ("jamba-v0.1-52b", "train_4k"): {"microbatch": 8,
                                     "moment_dtype": "bfloat16"},
    ("starcoder2-15b", "train_4k"): {"microbatch": 4, "unit_group": 2},
    ("gemma3-4b", "train_4k"): {"microbatch": 8},
    ("xlstm-1.3b", "train_4k"): {"microbatch": 8, "unit_group": 2},
    ("tinyllama-1.1b", "train_4k"): {"microbatch": 2},
    ("hubert-xlarge", "train_4k"): {"microbatch": 2},
    ("qwen2-moe-a2.7b", "train_4k"): {"microbatch": 4},
}
KEPT = ("microbatch", "unit_group")


def knobs_for(arch: str, shape: str) -> tuple[PerfKnobs, dict]:
    """(the knobs this pair runs with, the reference's knobs dropped)."""
    ref = REFERENCE_KNOBS.get((get_config(arch).name, shape), {})
    kept = {k: v for k, v in ref.items() if k in KEPT}
    dropped = {k: v for k, v in ref.items() if k not in KEPT}
    return PerfKnobs(**kept), dropped


def _meta_inputs(cfg, shape: InputShape) -> dict:
    """The step's batch as meta tensors (``launch.specs``)."""
    table = (specs.decode_token_specs(cfg, shape) if shape.kind == "decode"
             else specs.batch_specs(cfg, shape))
    if shape.kind == "prefill":
        table = {k: v for k, v in table.items() if k in ("tokens", "embeds")}
    return {k: torch.empty(s, dtype=dt, device=META)
            for k, (s, dt) in table.items()}


def _storages(tree) -> dict:
    """Storage key -> bytes of every tensor in ``tree``."""
    out = {}

    def rec(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st._cdata] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                rec(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                rec(v)
        elif hasattr(x, "__dict__"):            # OptState
            rec(vars(x))

    rec(tree)
    return out


def trace_step(cfg, shape: InputShape, knobs: PerfKnobs) -> dict:
    """Build the model on meta, trace one step under ``OpCounter``:
    (memory, cost, total parameters)."""
    model = model_lib.init_model(cfg, device=META)
    inputs = _meta_inputs(cfg, shape)
    args = {"parameter": dict(model.named_parameters()), "input": inputs}
    if shape.kind == "train":
        args["optimizer"] = adamw_init(model)
    elif shape.kind == "decode":
        args["cache"] = model_lib.init_decode_state(
            cfg, shape.global_batch, shape.seq_len, device=META)
    arg_bytes = _storages(args)
    groups = {f"{name}_bytes": sum(_storages(v).values())
              for name, v in args.items()}
    with OpCounter() as counter:
        if shape.kind == "train":
            out = steps.train_step(model, args["optimizer"], inputs,
                                   knobs=knobs, device=META)
        elif shape.kind == "prefill":
            out = steps.prefill_step(model, inputs, device=META)
        else:
            out = steps.serve_step(model, args["cache"], inputs["tokens"],
                                   shape.seq_len - 1, device=META)
    out_bytes = {k: n for k, n in _storages(out).items()
                 if k not in arg_bytes}
    argument = sum(arg_bytes.values())
    temp = counter.peak_bytes
    card = (torch.cuda.get_device_properties(0).total_memory
            if torch.cuda.is_available() else HW.hbm_bytes)
    memory = {"argument_bytes": argument, **groups,
              "output_bytes": sum(out_bytes.values()),
              "temp_bytes": temp,
              "peak_bytes_per_device": argument + temp,
              "device_bytes": card,
              "fits_one_card": argument + temp <= card}
    return {"memory": memory, "cost": counter.totals(),
            "total_params": model_lib.count_params(model)}


def run_one(arch: str, shape, tag: str = "", knobs: PerfKnobs | None = None,
            save: bool = True, out_dir: Path | None = None) -> dict:
    """Judge and trace one pair; ``shape`` is a name of ``INPUT_SHAPES``
    or an ``InputShape``.  Returns the record (and saves it)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": arch, "shape": shape.name, "mesh": None, "tag": tag,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "kind": shape.kind}
    ok, reason = specs.applicable(cfg, shape)
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return _done(rec, save, out_dir)
    dropped = {}
    if knobs is None:
        knobs, dropped = knobs_for(arch, shape.name)
    t0 = time.perf_counter()
    try:
        traced = trace_step(cfg, shape, knobs)
    except Exception as e:  # noqa: BLE001 — record the failure verbatim
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        return _done(rec, save, out_dir)
    cost = traced["cost"]
    rl = Roofline(flops=cost["dot_flops"], hbm_bytes=cost["traffic_bytes"],
                  collective_bytes=cost["collective_bytes"], hw=HW)
    act = active_params(cfg, traced["total_params"])
    mf = model_flops(cfg, shape, act)
    rec.update(
        status="OK",
        knobs={"microbatch": knobs.microbatch,
               "moment_dtype": knobs.moment_dtype, "remat": knobs.remat,
               "unit_group": knobs.unit_group},
        dropped_knobs=dropped,
        n_chips=1,
        trace_s=time.perf_counter() - t0,
        total_params=traced["total_params"],
        active_params=int(act),
        memory=traced["memory"],
        cost=cost,
        roofline=rl.as_dict(),
        model_flops=mf,
        useful_flops_frac=(mf / cost["dot_flops"] if cost["dot_flops"]
                           else None))
    return _done(rec, save, out_dir)


def _done(rec: dict, save: bool, out_dir: Path | None) -> dict:
    if save:
        d = Path(out_dir or OUT_DIR)
        d.mkdir(parents=True, exist_ok=True)
        tag = f"_{rec['tag']}" if rec.get("tag") else ""
        with open(d / f"{rec['arch']}_{rec['shape']}{tag}.json", "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Dry-run (arch x shape) pairs on the meta device.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every architecture and shape (the default "
                         "without --arch/--shape)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the records")
    ap.add_argument("--mesh", default=None,
                    help="not ported yet (refused): the pod meshes need "
                         "the sharding rules and 256-512 devices")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        ap.error("--mesh is not ported yet (the sharded dry run over the "
                 "pod meshes, ROADMAP queue 1 item 16)")
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    results = []
    for a in archs:
        for s in shapes:
            t0 = time.time()
            rec = run_one(a, s, tag=args.tag, out_dir=Path(args.out))
            status = rec["status"]
            if status == "OK":
                mem = rec["memory"]
                extra = (f"dom={rec['roofline']['dominant']} "
                         f"t_bound={rec['roofline']['t_bound_s']:.4g}s "
                         f"peak={mem['peak_bytes_per_device'] / 2**30:.2f}GiB "
                         f"fits={mem['fits_one_card']}")
            elif status == "FAIL":
                extra = rec["error"][:160]
            else:
                extra = rec["reason"][:90]
            print(f"[{status:4s}] {a:18s} {s:12s} "
                  f"({time.time() - t0:6.1f}s) {extra}", flush=True)
            results.append(rec)
    n = {k: sum(r["status"] == k for r in results)
         for k in ("OK", "SKIP", "FAIL")}
    print(f"done: {n['OK']} OK, {n['SKIP']} SKIP, {n['FAIL']} FAIL")
    return 1 if n["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
