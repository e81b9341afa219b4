"""Launch-config autotuner of the port's kernels (the port of
``repro.launch.autotune``).

For each (kernel, batch) point the tuner builds a representative
workload on the card, launches it at every launch geometry the
kernel's wrapper takes, times each on the card and writes the winner
to the table the wrappers consult (``kernels.tiles``)::

    {"version": 1,
     "cuda:<card name>": {"<kernel>": {"<batch>": {
         "k_groups": 8, "threads": 128,            # the winner's geometry
         "shape": {...},                           # the workload swept
         "modeled_s": ..., "measured_s": ...,
         "default": {"k_groups": 16, ..., "measured_s": ...},
         "candidates_s": {"1": ..., "2": ..., ...}}}}}

The geometry each kernel takes (where the caller leaves it unset):

  * ``router_score`` / ``router_cascade``: ``k_groups`` (1 to 128, a
    power of two; the threads follow), at the paper router's head
    (d = hh = 128, 11 experts, 2 constraints), at the engine's bucket
    sizes 1-32 (``--batches`` overrides);
  * ``flash_attention``: ``warps`` a block (1, 2, 4), at the router
    encoder's attention (S 128, 4 heads of 32, f32, bidirectional), at
    batches 1, 8 and 32;
  * ``mlstm_scan``: the chunk (16, 32, 64), at xlstm-1.3b's prefill
    (4 x 512, 4 heads of 1024).

Every entry records the effective geometry the wrapper's own plan gives
(``decision_plan``, ``forward_plan``, ``forward_chunk``), so the table
cannot say other than what ran.

Ranking.  The reference ranks candidates by a roofline modelled from
each candidate's compiled HLO.  A hand-written kernel's work is the
same at every launch geometry, so there is no such model here: every
valid candidate is timed on the card (20 calls captured in a CUDA graph
after a warm-up, the graph replayed between CUDA events, the median of
``--repeats`` replays: the device's time, without the host's launch
path), and the fastest wins.  ``--no-measure`` times nothing and
records each kernel's default geometry, with ``modeled_s`` the kernel's
roofline bound (its FLOPs and bytes under the ``h100`` preset); it runs
without a card and is what the tests use.  Measuring without a card
raises.

    python -m repro_torch.launch.autotune --out experiments/tryage/tile_table_torch.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import tiles
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops
from repro_torch.launch.roofline import HWPreset, Roofline, resolve_preset

ROUTER = {"d": 128, "hh": 128, "M": 11, "n_c": 2}
ATTENTION = {"S": 128, "H": 4, "hd": 32}
MLSTM = {"S": 512, "H": 4, "dh": 1024}


@dataclasses.dataclass
class Candidate:
    """One launch geometry of one (kernel, batch) workload."""

    params: dict                  # the geometry argument the wrapper takes
    record: dict                  # the effective geometry of its plan
    run: Callable                 # zero-arg call on the card
    measured_s: float | None = None


@dataclasses.dataclass
class Workload:
    """A (kernel, batch) point: its shape, its work and its candidates;
    ``default`` is the geometry the wrapper takes without a table."""

    shape: dict
    cost: tuple                   # (FLOPs, bytes) of one call
    candidates: list
    default: dict                 # the default candidate's params


def _inputs(make):
    """``make()`` once, on the first call of any candidate."""
    box = []

    def get():
        if not box:
            box.append(make())
        return box[0]
    return get


def _router(B: int, rng, cascade: bool) -> Workload:
    d, hh, M, n_c = (ROUTER[k] for k in ("d", "hh", "M", "n_c"))
    heads = 2 if cascade else 1

    def make():
        f = lambda *s: torch.tensor(rng.standard_normal(s), device="cuda",
                                    dtype=torch.float32)
        args = [f(B, d), f(d, hh), f(hh), f(hh, M), f(M)]
        if cascade:
            args += [f(d, hh), f(hh), f(hh, M), f(M)]
        args += [f(n_c, M), f(B, n_c).abs()]
        if cascade:
            args.append(torch.tensor(rng.permutation(M), device="cuda",
                                     dtype=torch.int32))
        return args

    get = _inputs(make)
    fn = (rc_ops.router_score_cascade_fused if cascade
          else rs_ops.router_score_fused)
    cands = []
    k = 1
    while rs_ops.valid_k_groups(k, d):
        plan = rs_ops.decision_plan(B, d, hh, heads, k_groups=k)
        cands.append(Candidate(
            {"k_groups": k}, {"threads": plan["threads"]},
            lambda k=k: fn(*get(), k_groups=k)))
        k *= 2
    units = heads * -(-hh // rs_ops.CLUSTER)
    return Workload({"B": B, **ROUTER},
                    rs_ops.head_cost(B, d, hh, M, n_c, cascade), cands,
                    {"k_groups": rs_ops.default_k_groups(d, units)})


def _router_candidates(B, rng):
    return _router(B, rng, cascade=False)


def _cascade_candidates(B, rng):
    return _router(B, rng, cascade=True)


def _flash_candidates(B: int, rng) -> Workload:
    S, H, hd = (ATTENTION[k] for k in ("S", "H", "hd"))
    get = _inputs(lambda: [torch.tensor(rng.standard_normal((B, S, H, hd)),
                                        device="cuda", dtype=torch.float32)
                           for _ in range(3)])
    cands = []
    for w in fa_ops.WARPS:
        plan = fa_ops.forward_plan(B, S, H, hd, warps=w)
        cands.append(Candidate(
            {"warps": w}, {"grid": list(plan["grid"])},
            lambda w=w: fa_ops.flash_attention(*get(), causal=False,
                                               warps=w)))
    meta = torch.empty(B, S, H, hd, device="meta")
    return Workload({"B": B, **ATTENTION, "causal": False, "dtype": "float32"},
                    fa_ops.forward_cost(meta, meta, False, 0), cands,
                    {"warps": fa_ops.default_warps(B, S, H, hd)})


def _mlstm_candidates(B: int, rng) -> Workload:
    S, H, dh = (MLSTM[k] for k in ("S", "H", "dh"))

    def make():
        f = lambda *s: torch.tensor(rng.standard_normal(s), device="cuda",
                                    dtype=torch.float32)
        state = {"C": torch.zeros(B, H, dh, dh, device="cuda"),
                 "n": torch.zeros(B, H, dh, device="cuda"),
                 "m": torch.zeros(B, H, device="cuda")}
        return [f(B, S, H, dh), f(B, S, H, dh), f(B, S, H, dh), f(B, S, H),
                f(B, S, H) + 3.0, state]

    get = _inputs(make)
    cands = [Candidate({"chunk": L}, {"chunks": S // L},
                       lambda L=L: ml_ops.mlstm_chunkwise(*get(), chunk=L))
             for L in (16, 32, 64) if ml_ops.valid_chunk(L, S)]
    default = ml_ops.pick_chunk(S, ml_ops.MAX_CHUNK)
    return Workload({"B": B, **MLSTM}, ml_ops.forward_cost(B, S, H, dh,
                                                           default),
                    cands, {"chunk": default})


# kernel -> (workload builder, default batches, --fast batches).  The
# router kernels tune at the engine's bucket sizes; the model kernels
# over their model-batch axis, which their plans key ``tiles.tile_for``
# on.
KERNELS = {
    "router_score": (_router_candidates, (1, 2, 4, 8, 16, 32), (1, 32)),
    "router_cascade": (_cascade_candidates, (1, 2, 4, 8, 16, 32), (1, 32)),
    "flash_attention": (_flash_candidates, (1, 8, 32), (1,)),
    "mlstm_scan": (_mlstm_candidates, (4,), (1,)),
}


def modeled_s(work: Workload, hw: HWPreset) -> float:
    """The kernel's roofline bound (seconds) under ``hw``: the same for
    every geometry."""
    flops, nbytes = work.cost
    return Roofline(flops=flops, hbm_bytes=nbytes, collective_bytes=0.0,
                    hw=hw).t_bound


def measure_candidate(cand: Candidate, repeats: int, iters: int = 20) -> float:
    """Median seconds a call on the card: ``iters`` calls captured in one
    CUDA graph after a warm-up, the graph replayed ``repeats`` times
    between CUDA events.  The replay leaves out the host's launch path,
    which at the router's sizes takes longer than the kernel and would
    hide what the geometry changes."""
    for _ in range(3):
        cand.run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            cand.run()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(max(1, repeats)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return float(np.median(times))


def tune_kernel(kernel: str, batches, hw: HWPreset, *, repeats: int = 5,
                measure: bool = True, seed: int = 0) -> dict:
    """Sweep one kernel over ``batches``; returns {batch: entry}."""
    builder = KERNELS[kernel][0]
    out = {}
    for B in batches:
        work = builder(int(B), np.random.default_rng(seed + int(B)))
        default = next(c for c in work.candidates
                       if c.params == work.default)
        if measure:
            for c in work.candidates:
                c.measured_s = measure_candidate(c, repeats)
            winner = min(work.candidates, key=lambda c: c.measured_s)
        else:
            winner = default
        out[int(B)] = {
            **winner.params, **winner.record, "shape": work.shape,
            "modeled_s": modeled_s(work, hw),
            "measured_s": winner.measured_s,
            "default": {**default.params, **default.record,
                        "measured_s": default.measured_s},
            "candidates_s": ({str(next(iter(c.params.values()))):
                              c.measured_s for c in work.candidates}
                             if measure else None)}
    return out


def autotune(kernels=None, batches=None, preset: str | None = "h100", *,
             repeats: int = 5, measure: bool = True, fast: bool = False,
             seed: int = 0, log=None) -> dict:
    """Run the sweep; returns the table (not yet written) under this
    process's key (``tiles.backend_key()``).  ``batches`` overrides the
    router kernels' batch list; ``fast`` takes the short lists."""
    if measure and not torch.cuda.is_available():
        raise RuntimeError("autotune: measuring needs a CUDA card; "
                           "--no-measure records the default geometry")
    hw = resolve_preset(preset)
    backend = tiles.backend_key()
    table: dict = {"version": 1, backend: {}}
    for kernel in (kernels or list(KERNELS)):
        _, full, quick = KERNELS[kernel]
        bs = quick if fast else full
        if kernel.startswith("router") and batches:
            bs = batches
        if log:
            log(f"[autotune] {kernel} @ {list(bs)} on {backend} "
                f"(hw={hw.name}, measure={measure})")
        entries = tune_kernel(kernel, bs, hw, repeats=repeats,
                              measure=measure, seed=seed)
        table[backend][kernel] = {str(b): e for b, e in entries.items()}
        if log:
            for b, e in entries.items():
                log(f"[autotune]   batch {b}: {json.dumps(e)}")
    return table


def write_table(table: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def merge_table(new: dict, path: str) -> dict:
    """Overlay ``new`` onto an existing table file (other cards and
    kernels keep their entries); returns the merged dict."""
    try:
        with open(path) as f:
            old = json.load(f)
        if not isinstance(old, dict):
            raise ValueError(path)
    except (OSError, ValueError):
        return new
    for backend, kernels in new.items():
        if backend == "version":
            continue
        dst = old.setdefault(backend, {})
        for kernel, entries in kernels.items():
            dst.setdefault(kernel, {}).update(entries)
    old["version"] = new.get("version", 1)
    return old


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.autotune",
        description=__doc__.splitlines()[0])
    p.add_argument("--out", default=tiles.DEFAULT_PATH,
                   help="table path (merged with existing entries)")
    p.add_argument("--batches", type=lambda s: [int(x) for x in
                                                s.split(",")],
                   default=None,
                   help="the router kernels' batch list, e.g. 1,8,32")
    p.add_argument("--kernels", type=lambda s: s.split(","),
                   default=None, help="subset of " + ",".join(KERNELS))
    p.add_argument("--preset", default="h100",
                   help="hardware preset of modeled_s: h100, auto, ...")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--no-measure", action="store_true",
                   help="time nothing: record the default geometry")
    p.add_argument("--fast", action="store_true",
                   help="short batch lists for smoke runs")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    for k in args.kernels or ():
        if k not in KERNELS:
            p.error(f"unknown kernel {k!r} (have {', '.join(KERNELS)})")
    table = autotune(args.kernels, args.batches, args.preset,
                     repeats=args.repeats, measure=not args.no_measure,
                     fast=args.fast, seed=args.seed, log=print)
    write_table(merge_table(table, args.out), args.out)
    print(f"[autotune] wrote {args.out}")


if __name__ == "__main__":
    main()
