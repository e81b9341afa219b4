"""Dry run: judge each (arch x shape) pair without running a model,
and count its step's work on one card or on each device of a pod mesh
(the port of ``repro.launch.dryrun``).

The reference lowers and compiles each pair on a 512-device host mesh
and reads XLA's memory and cost analyses.  The port has no compiler to
ask: it traces the step that ``launch.steps`` runs (``train_step``,
``prefill_step`` or ``serve_step``, as the reference's ``build_step``
picks it) on the ``meta`` device, where tensors have shapes and types
and no storage, so no weight is allocated and nothing is launched, under
``launch.op_costs.OpCounter``.  ``trace_step(..., device=)`` runs the
same step for real on another device, every loop iteration run: what
the tests and the card hold the trace against.  Each record holds:

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
  * ``loops``: each loop counted by trip count (name, trip count, the
    runs it stands for, the runs and iterations traced), as the
    reference weights a while body by its trip count: on ``meta`` a
    loop of n steps is traced as its first step, one middle step
    counted n - 2 times and its last (``launch.op_costs.counted_loop``;
    the sLSTM's loop over time and its loop over chunks), so that
    xlstm-1.3b's 32,768-step prefill and 4,096-step training traces in
    seconds to minutes, not hours;
  * ``status`` (``OK``, ``SKIP`` with the reason ``launch.specs``
    gives, or ``FAIL`` with ``error`` and ``trace``) and ``trace_s``,
    the seconds the trace took.

With ``--mesh pod`` (16 x 16, 256 devices) or ``--mesh multipod``
(2 x 16 x 16, 512) each pair is traced as rank 0 of a ``fake`` process
group of that size (``launch.mesh.fake_world``) on a ``DeviceMesh`` of
the pod's shape: the model, the AdamW moments, the batch and the decode
state are DTensors of ``meta`` shards laid out by the logical rules
(``launch.steps.rules_for``, the pair's ``rule_overrides`` included)
and the step runs sharded (``mesh=``).  The counter then counts one
device's work, as the reference's post-SPMD numbers are, and each
record adds the reference's per-device fields: ``n_chips``, ``memory``
of one device (arguments as local shards), ``collectives`` (bytes and
counts by kind; the fake group's mesh is a CPU one, where DTensor turns
an all-to-all into an all-gather and a slice), a ``roofline`` with the
collective term, ``model_flops_global``, ``model_flops_per_chip`` and
``useful_flops_frac`` (per chip).  Without ``--mesh`` the records are
the one-card ones.

``knobs_for`` keeps the reference's per-pair knobs that the port runs
(``microbatch``, ``unit_group``, and on a mesh ``rule_overrides``);
``moment_dtype`` is ``float32`` (``train_step`` refuses bf16 moments)
and without a mesh ``rule_overrides`` lays out nothing: each knob
dropped is written into the record with the reference's value.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod \\
      --arch qwen1.5-0.5b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-1.3b \\
      --shape train_4k [--mesh pod|multipod]

Runs on any host: the meta device needs no card.  Records go to
``experiments/dryrun_torch/`` (``--out``).
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import specs, steps
from repro_torch.launch.mesh import fake_world, production_shape
from repro_torch.launch.op_costs import OpCounter
from repro_torch.launch.roofline import (PRESETS, Roofline, active_params,
                                         model_flops)
from repro_torch.launch.steps import PerfKnobs
from repro_torch.models import model as model_lib
from repro_torch.models.common import INPUT_SHAPES, InputShape
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding.context import is_dtensor

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
HW = PRESETS["h100"]
META = torch.device("meta")

# The reference's per-pair knobs (src/repro/launch/dryrun.py:31-84):
# (arch, shape) -> {knob: value}.  bf16 moments are dropped here, and
# rule_overrides without a mesh.
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
MESH_KEPT = KEPT + ("rule_overrides",)
MESHES = {"pod": False, "multipod": True}     # --mesh -> multi_pod


def knobs_for(arch: str, shape: str,
              mesh: str | None = None) -> tuple[PerfKnobs, dict]:
    """(the knobs this pair runs with, the reference's knobs dropped)."""
    ref = REFERENCE_KNOBS.get((get_config(arch).name, shape), {})
    keep = KEPT if mesh is None else MESH_KEPT
    kept = {k: v for k, v in ref.items() if k in keep}
    dropped = {k: v for k, v in ref.items() if k not in keep}
    return PerfKnobs(**kept), dropped


def _inputs(cfg, shape: InputShape, device=META) -> dict:
    """The step's batch (``launch.specs``): meta tensors, or zeros on
    another device."""
    table = (specs.decode_token_specs(cfg, shape) if shape.kind == "decode"
             else specs.batch_specs(cfg, shape))
    if shape.kind == "prefill":
        table = {k: v for k, v in table.items() if k in ("tokens", "embeds")}
    make = torch.empty if torch.device(device) == META else torch.zeros
    return {k: make(s, dtype=dt, device=device)
            for k, (s, dt) in table.items()}


def _storages(tree) -> dict:
    """Storage key -> bytes of every tensor in ``tree`` (a DTensor's:
    this device's shard)."""
    out = {}

    def rec(x):
        if is_dtensor(x):
            rec(x.to_local())
        elif isinstance(x, torch.Tensor):
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


def trace_step(cfg, shape: InputShape, knobs: PerfKnobs,
               mesh=None, device=META, top: int | None = 25) -> dict:
    """Build the model on meta, trace one step under ``OpCounter``:
    (memory, cost, total parameters).  With ``mesh`` (a ``DeviceMesh``
    of a fake world) the step runs sharded and every number is one
    device's: the model, moments, batch and state are laid out by the
    rules first, and the batch counts as its shard (the step lays each
    microbatch out as it cuts it).  ``device``: another device runs the
    same step for real (weights from seed 0, zeros for a batch), every
    loop iteration run: what the trace is held against.  ``top``: how
    many ops the histogram keeps (None: all)."""
    model = model_lib.init_model(cfg, device=device)
    total = model_lib.count_params(model)
    inputs = _inputs(cfg, shape, device)
    rules = None
    if mesh is not None:
        rules = steps.rules_for(mesh, knobs)
        steps.shard_model(model, mesh, rules)
    args = {"parameter": dict(model.named_parameters()),
            "input": (inputs if mesh is None
                      else steps.shard_batch(inputs, mesh, rules))}
    if shape.kind == "train":
        args["optimizer"] = adamw_init(model)
    elif shape.kind == "decode":
        args["cache"] = model_lib.init_decode_state(
            cfg, shape.global_batch, shape.seq_len, device=device)
        if mesh is not None:
            args["cache"] = steps.shard_decode_state(args["cache"], cfg,
                                                     mesh, rules)
    arg_bytes = _storages(args)
    groups = {f"{name}_bytes": sum(_storages(v).values())
              for name, v in args.items()}
    if mesh is not None and shape.kind == "train":
        args["input"] = inputs

    def step():
        if shape.kind == "train":
            return steps.train_step(model, args["optimizer"], args["input"],
                                    knobs=knobs, device=device, mesh=mesh)
        if shape.kind == "prefill":
            return steps.prefill_step(model, args["input"], device=device,
                                      mesh=mesh, knobs=knobs)
        return steps.serve_step(model, args["cache"], args["input"]["tokens"],
                                shape.seq_len - 1, device=device, mesh=mesh,
                                knobs=knobs)

    if mesh is not None:
        # fill DTensor's sharding-propagation cache first: its shape
        # inference runs each new op on global-size meta tensors, which
        # the counter would take for this device's temporaries
        step()
    with OpCounter() as counter:
        out = step()
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
    return {"memory": memory, "cost": counter.totals(top),
            "total_params": total}


def run_one(arch: str, shape, tag: str = "", knobs: PerfKnobs | None = None,
            save: bool = True, out_dir: Path | None = None,
            mesh: str | None = None) -> dict:
    """Judge and trace one pair; ``shape`` is a name of ``INPUT_SHAPES``
    or an ``InputShape``; ``mesh`` is ``None`` (one card), ``"pod"`` or
    ``"multipod"``.  Returns the record (and saves it)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    if mesh is not None and mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r} not in {sorted(MESHES)}")
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh, "tag": tag,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "kind": shape.kind}
    ok, reason = specs.applicable(cfg, shape)
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return _done(rec, save, out_dir)
    dropped = {}
    if knobs is None:
        knobs, dropped = knobs_for(arch, shape.name, mesh)
    t0 = time.perf_counter()
    try:
        if mesh is None:
            traced, n_chips = trace_step(cfg, shape, knobs), 1
        else:
            traced, n_chips = _trace_on_mesh(cfg, shape, knobs, mesh)
    except Exception as e:  # noqa: BLE001 — record the failure verbatim
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        return _done(rec, save, out_dir)
    cost = traced["cost"]
    rl = Roofline(flops=cost["dot_flops"], hbm_bytes=cost["traffic_bytes"],
                  collective_bytes=cost["collective_bytes"], hw=HW)
    act = active_params(cfg, traced["total_params"])
    mf = model_flops(cfg, shape, act)
    knob_rec = {"microbatch": knobs.microbatch,
                "moment_dtype": knobs.moment_dtype, "remat": knobs.remat,
                "unit_group": knobs.unit_group}
    if mesh is not None:
        knob_rec["rule_overrides"] = knobs.rule_overrides
    rec.update(
        status="OK",
        loops=cost.pop("loops"),
        knobs=knob_rec,
        dropped_knobs=dropped,
        n_chips=n_chips,
        trace_s=time.perf_counter() - t0,
        total_params=traced["total_params"],
        active_params=int(act),
        memory=traced["memory"],
        cost=cost,
        roofline=rl.as_dict())
    if mesh is None:
        rec.update(model_flops=mf,
                   useful_flops_frac=(mf / cost["dot_flops"]
                                      if cost["dot_flops"] else None))
    else:
        rec.update(collectives=cost["collectives"], model_flops_global=mf,
                   model_flops_per_chip=mf / n_chips,
                   useful_flops_frac=(mf / n_chips / cost["dot_flops"]
                                      if cost["dot_flops"] else None))
    return _done(rec, save, out_dir)


def _trace_on_mesh(cfg, shape: InputShape, knobs: PerfKnobs, mesh: str):
    """``trace_step`` as rank 0 of a fake world of the pod mesh's size:
    (traced, number of devices)."""
    from torch.distributed.device_mesh import init_device_mesh

    dims, names = production_shape(MESHES[mesh])
    n = math.prod(dims)
    with fake_world(n):
        dmesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        return trace_step(cfg, shape, knobs, mesh=dmesh), n


def _done(rec: dict, save: bool, out_dir: Path | None) -> dict:
    if save:
        d = Path(out_dir or OUT_DIR)
        d.mkdir(parents=True, exist_ok=True)
        tag = f"_{rec['tag']}" if rec.get("tag") else ""
        mesh = f"_{rec['mesh']}" if rec.get("mesh") else ""
        with open(d / f"{rec['arch']}_{rec['shape']}{mesh}{tag}.json",
                  "w") as f:
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
    ap.add_argument("--mesh", default=None, choices=sorted(MESHES),
                    help="trace one device of the 16 x 16 pod or the "
                         "2 x 16 x 16 multipod (a fake process group of "
                         "256 or 512 ranks); default: one card")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    results = []
    for a in archs:
        for s in shapes:
            t0 = time.time()
            rec = run_one(a, s, tag=args.tag, out_dir=Path(args.out),
                          mesh=args.mesh)
            status = rec["status"]
            if status == "OK":
                mem = rec["memory"]
                extra = (f"dom={rec['roofline']['dominant']} "
                         f"t_bound={rec['roofline']['t_bound_s']:.4g}s "
                         f"peak={mem['peak_bytes_per_device'] / 2**30:.2f}GiB "
                         f"fits={mem['fits_one_card']}")
                if args.mesh:
                    coll = rec["collectives"]["total_bytes"] / 2**30
                    extra += f" coll={coll:.3f}GiB"
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
