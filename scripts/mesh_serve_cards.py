#!/usr/bin/env python3
"""Serve the Tryage library on (data, model) meshes of separate cards and
hold every mesh to the meshless engine.

    python3 scripts/mesh_serve_cards.py [--repeats 3] [--cpu] [--gate-only]
                                        [--out FILE]

One process over every visible card, no process group: the engine's mesh
puts router and expert replicas on the cards itself.  The workload is
``chip_smoke.py``'s main path: the 11 experts of
``paper_library_specs(vocab=512)`` and the router with an uncertainty
head (seeded random weights on ``cuda:0``), the cascade threshold at the
median confidence of the cascade rows' first picks, 256 requests at seq
128, ``max_batch=32``, ``lane_target=8``, ``fused_cascade=True``,
``replicate_hot=1``, each engine on its own test clock that only the
script advances.  For each mesh (``make_host_mesh(d, m)``: the first
``d * m`` cards), against the meshless engine on ``cuda:0``:

(a) ``serve()`` and ``run()``: one Result per request; choices, cascade
    and fallback depths as meshless except where the meshless row is a
    near tie (top-two constrained scores, or confidence and threshold,
    under 1e-5 apart; counted); NLL within rtol 1e-5.
(b) streams: stream flushes sum to the engine's; each expert flushes only
    on its placement slices' streams; on the test clock more than one card
    flushes wherever ``model > 1``; on the host clock (f) every card does
    work (expert flushes, or the router's block on a data card).
(c) launches: ``router_score`` launches ``data`` times a router batch
    decided by it (``router_cascade`` decides the rest at ``data`` 1,
    as many times as meshless, and never at ``data > 1``); per card, from
    the profiler's device index, ``router_score`` on every data card and
    ``flash_attention`` on every card whose streams flushed.
(d) failures: with an ``ExpertHealth`` and every flush of the busiest
    expert failing, failures land only on its streams and no request is
    lost; decisions as the meshless engine's under the same failures.
(e) adaptation (meshes with ``data > 1``): the online-adapting engine
    decides as the meshless adapting one, and after the last swap every
    data card's router replica holds the live version's weights and
    predicts as the live router does.
(f) throughput (reported, not gated): req/s of ``run()`` and ``serve()``
    on the host clock, medians of ``--repeats`` after ``warm_mesh``
    beside the meshless engine and a (1, 1) mesh; each card's busy share
    from the profiler; StreamClock's makespan speed-up over the (1, 1)
    mesh beside the wall-clock speed-up over meshless.

Each serving kernel on each card: ``router_score_fused``,
``router_score_cascade_fused`` and ``flash_attention`` (f32 at the
router's shape, bf16 at tinyllama's) with ``cuda:0`` current, held to
the plain version on that card (router 1e-5; attention 2e-5, bf16 one
bf16 ulp past it) and to ``cuda:0``'s output bit for bit; and the host
cost of a ``router_score_fused`` call on each card (CUDA events and the
host clock over 200 calls after 20, medians of 3 rounds), which pays
the device switch of ``kernels.build.launch`` off the current card.

The CLI: ``python -m repro_torch.launch.serve --fifo --requests 256
--cascade 0.6 --fused-cascade --mesh 2,2 --replicate-hot 1`` and
``--mesh 1,4`` (needing four cards) must exit 0, answer every request
and flush on more than one card.  Without trained artifacts the first
run trains the CLI's reduced experiment on ``cuda:0`` first.

The mesh gate (``benchmarks/run.py``'s ``bench_mesh`` through
``launch.gates.mesh``): its eight-expert library and router drawn from
seeds on ``cuda:0``, 256 mixed-flag requests on (1, 1), (1, 2) and (1,
4) meshes of separate cards, each warmed (``warm_mesh``) and then timed;
the (2, 4) mesh needs eight cards, and with fewer it is skipped with
that reason.
Choices must be identical across sizes and the simulated tokens/s
(StreamClock's makespan) at size 4 must be >= 3x size 1; the wall
tokens/s stand beside it, not gated, as in the reference.
``--gate-only`` runs this case alone.

``--cpu`` runs the same cases over repeated CPU slots
(``make_host_mesh(d, m, devices=["cpu"] * (d * m), platform="cpu")``)
on a tiny library drawn from a seed (three encoders of 1-2 layers,
widths 32-64, vocabulary 64): it checks the script, not the numbers;
the per-card profile is not taken, and the CLI is held to the count
error a (2, 2) mesh over the one CPU device raises.  Prints one JSON
object (and writes it to ``--out``) with the cards' names and power
limits as ``nvidia-smi`` gives them; exits non-zero when a case failed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MESHES = ("1x2", "2x1", "2x2", "1x4")
CHOICE_GAP = 1e-5      # a choice may differ only below this top-two gap
NLL_RTOL = 1e-5
ROUTER_TOL = 1e-5      # router heads against the plain version
ATTN_TOL = 2e-5        # attention: online vs full softmax summation order
LANE_TARGET = 8
# the README's flag phrases; the unique prompts repeat with the same flags
FLAG_TEXTS = ["", "[Flag: Prefer small]", "[Flag: Smallest model]",
              "[Flag: Newest model]", "[Flag: Best model]",
              "[Flag: Small model] [Flag: Recent model]"]
# (requests, unique prompts, seq, max_batch) on the cards and with --cpu
SIZES = {"card": (256, 192, 128, 32), "cpu": (64, 48, 32, 16)}
# online adaptation, as tests/test_torch_mesh.py's (2, 1) case
ADAPT = {"adapt_every": 16, "adapt_batch": 8, "adapt_lr": 0.05}
# kernel shapes: router heads (B, d, hh, M, n_c); attention (B, S, H,
# KV, hd, causal, dtype): the router's layer, then tinyllama's prefill
KERNEL_SHAPES = {
    "card": {"heads": [(32, 128, 128, 11, 2), (37, 128, 128, 11, 2)],
             "attention": [(32, 128, 4, 4, 32, False, "float32"),
                           (4, 512, 32, 4, 64, True, "bfloat16")]},
    "cpu": {"heads": [(5, 32, 32, 3, 2)],
            "attention": [(2, 16, 2, 2, 16, False, "float32"),
                          (1, 16, 4, 2, 16, True, "bfloat16")]}}
CLI_ARGS = ["--fifo", "--requests", "256", "--cascade", "0.6",
            "--fused-cascade"]
CLI_MESHES = (("2,2", ["--replicate-hot", "1"]), ("1,4", []))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class PhaseClock:
    """An engine clock that only the script advances."""

    def __init__(self, t: float = 1.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


# ------------------------------------------------------------ workload

def make_requests(mb, thr, n, n_unique, max_batch):
    """``n`` requests: prompt i % n_unique, flag text i % 6, and a
    confidence floor on every fourth admission batch from the second."""
    from repro_torch.serving import Request, parse_flags
    return [Request(uid=i, tokens=mb["tokens"][i % n_unique],
                    targets=mb["targets"][i % n_unique],
                    mask=mb["mask"][i % n_unique],
                    lambdas=parse_flags(FLAG_TEXTS[i % len(FLAG_TEXTS)]),
                    min_confidence=(thr if (i // max_batch) % 4 == 1
                                    else 0.0))
            for i in range(n)]


def setup(torch, cpu: bool) -> SimpleNamespace:
    """The library, router, constraints, threshold and requests: the
    paper's library on ``cuda:0``, or a tiny one on the CPU."""
    from repro_torch.core import objective
    from repro_torch.core.library import (ExpertSpec, ModelLibrary, _enc,
                                          paper_library_specs)
    from repro_torch.core.router import (RouterConfig, init_router,
                                         predict_losses, predict_uncertainty)
    from repro_torch.data.batching import mlm_batch
    from repro_torch.data.corpus import DOMAINS, DomainCorpus
    from repro_torch.models.model import count_params, init_model
    from repro_torch.serving import lambda_matrix

    dev = "cpu" if cpu else "cuda:0"
    n, n_unique, seq, max_batch = SIZES["cpu" if cpu else "card"]
    if cpu:
        vocab = 64
        lib = ModelLibrary([
            ExpertSpec("small", _enc("small", 1, 32, 2, 64, vocab), {}, 0.5),
            ExpertSpec("mid", _enc("mid", 1, 48, 2, 96, vocab), {}, 0.5),
            ExpertSpec("big", _enc("big", 2, 64, 2, 128, vocab), {}, 0.9)])
        rc = RouterConfig(n_models=3, vocab_size=vocab, num_layers=1,
                          d_model=32, num_heads=2, d_ff=64)
    else:
        vocab = 512
        lib = ModelLibrary(paper_library_specs(vocab=vocab))
        rc = RouterConfig(n_models=len(lib), vocab_size=vocab)
    for i, e in enumerate(lib.experts):
        e.params = init_model(e.cfg, seed=100 + i, device=dev)
        e.n_params = count_params(e.params)
    router = init_router(rc, seed=7, uncertainty=True, device=dev)
    cons = [objective.size_constraint(lib), objective.recency_constraint(lib)]
    rng = np.random.default_rng(0)
    toks, _ = DomainCorpus(vocab_size=vocab, seed=0).sample_mixture(
        {d: 1.0 for d in DOMAINS}, n_unique, seq, rng)
    mb = mlm_batch(toks, rng, 0.15, vocab)

    # threshold: the median confidence of the cascade rows' first picks,
    # so that some rows escalate and some do not
    probe = [r for r in make_requests(mb, 1.0, n, n_unique, max_batch)
             if r.min_confidence > 0]
    with torch.inference_mode():
        tk = torch.from_numpy(np.stack([r.tokens for r in probe])).to(dev)
        pred = predict_losses(router, rc, {"tokens": tk}).cpu().numpy()
        sigma = predict_uncertainty(router, rc, {"tokens": tk}).cpu().numpy()
    cnames = [c.name for c in cons]
    cmat = objective.constraint_matrix(cons, len(lib))
    first = (pred + lambda_matrix(probe, cnames) @ cmat).argmin(1)
    conf = objective.confidence_scores(sigma)[np.arange(len(probe)), first]
    thr = float(np.median(conf))
    return SimpleNamespace(
        lib=lib, router=router, rc=rc, cons=cons, cnames=cnames, cmat=cmat,
        thr=thr, max_batch=max_batch,
        requests=lambda: make_requests(mb, thr, n, n_unique, max_batch))


# ----------------------------------------------------- engines and runs

def engine(s, now_fn, mesh=None, **kw):
    from repro_torch.device import module_device
    from repro_torch.serving import TryageEngine
    return TryageEngine(s.lib, s.router, s.rc, s.cons,
                        max_batch=getattr(s, "max_batch", 32),
                        fused_cascade=True, lane_target=LANE_TARGET,
                        max_wait_s=10.0, now_fn=now_fn, mesh=mesh,
                        replicate_hot=1, device=module_device(s.router),
                        **kw)


def serve(s, eng, clock=None, fail=None):
    """``serve()`` over the requests, the clock moved 1 ms an arrival;
    ``fail``: every flush of that expert fails.  Results by uid."""
    def arrivals():
        for i, r in enumerate(s.requests()):
            if i == 0 and fail is not None:
                eng.scheduler.inject_failures(fail, -1)
            if clock is not None:
                clock.t += 0.001
            yield r
    return by_uid(s, eng.serve(arrivals()), "serve()")


def run(s, eng):
    for r in s.requests():
        eng.submit(r)
    return by_uid(s, eng.run(), "run()")


def by_uid(s, results, what):
    res = sorted(results, key=lambda r: r.uid)
    check([r.uid for r in res] == list(range(len(s.requests()))),
          f"{what}: not one Result per request")
    return res


def near_tie(s, req, result) -> bool:
    """Whether the meshless ``result`` for ``req`` lies within CHOICE_GAP
    of another choice: its top-two constrained scores, or its confidence
    and the threshold."""
    from repro_torch.serving import lambda_matrix
    sc = np.sort(result.pred_losses
                 + lambda_matrix([req], s.cnames)[0] @ s.cmat)
    return (sc[1] - sc[0] < CHOICE_GAP
            or abs(result.confidence - s.thr) < CHOICE_GAP)


def decides_as(s, ref, got, what) -> dict:
    """Choices and depths as ``ref`` but at near ties, NLL within rtol
    1e-5; returns the rows excused and the largest relative NLL
    difference of the rows that agree."""
    excused, nll = 0, 0.0
    reqs = s.requests()
    for a, b in zip(ref, got):
        if ((a.expert, a.cascade_depth, a.fallback_depth, a.failed)
                != (b.expert, b.cascade_depth, b.fallback_depth, b.failed)):
            check(near_tie(s, reqs[a.uid], a),
                  f"{what}: uid {a.uid} {b.expert}@{b.cascade_depth} on "
                  f"the mesh, {a.expert}@{a.cascade_depth} without")
            excused += 1
        elif a.loss is not None:
            rel = abs(b.loss - a.loss) / abs(a.loss)
            check(rel <= NLL_RTOL, f"{what}: uid {a.uid} NLL {b.loss} vs "
                                   f"{a.loss}")
            nll = max(nll, rel)
    return {"near_tie_excused": excused, "nll_max_rel_diff": nll}


@contextlib.contextmanager
def card_trace(torch, on: bool):
    """Within the block, the card's activity under the profiler; yields
    a dict that, after the block, maps each card index to its kernel
    launches by name and its device busy time (ms).  Empty when ``on``
    is false (the CPU) or the trace holds no device events."""
    out: dict = {}
    if not on:
        yield out
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield out
        sync_all(torch)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        card = out.setdefault(int(e.device_index),
                              {"busy_ms": 0.0, "kernels": {}})
        card["busy_ms"] += e.time_range.elapsed_us() / 1e3
        card["kernels"][e.name] = card["kernels"].get(e.name, 0) + 1


def launches_on(trace: dict, kernel: str) -> dict:
    """Launches per card of the kernels whose names hold ``kernel``."""
    return {card: sum(n for name, n in t["kernels"].items()
                      if kernel in name)
            for card, t in sorted(trace.items())}


@contextlib.contextmanager
def decisions():
    """Within the block, the calls of the engine's two decision wrappers
    (``router_route``, which launches ``router_score``, and
    ``router_route_cascade``, which launches ``router_cascade``) by the
    device of their input; after it, under ``"launches"``, every
    wrapper's kernel launches (none on the CPU, where the wrappers run
    their plain versions)."""
    from repro_torch.kernels import launches
    from repro_torch.kernels.router_cascade import ops as rc_ops
    from repro_torch.kernels.router_score import ops as rs_ops
    out = {"router_score": {}, "router_cascade": {}}
    wrapped = [(rs_ops, "router_route", out["router_score"]),
               (rc_ops, "router_route_cascade", out["router_cascade"])]
    inner = [getattr(mod, fn) for mod, fn, _ in wrapped]
    for (mod, fn, calls), f in zip(wrapped, inner):
        def counted(emb, *args, _f=f, _calls=calls, **kw):
            _calls[str(emb.device)] = _calls.get(str(emb.device), 0) + 1
            return _f(emb, *args, **kw)
        setattr(mod, fn, counted)
    launches.reset_launch_counts()
    try:
        yield out
    finally:
        for (mod, fn, _), f in zip(wrapped, inner):
            setattr(mod, fn, f)
        out["launches"] = launches.launch_counts()


def with_flush_log(eng) -> list:
    """Log every (expert, stream) a flush of ``eng`` runs on."""
    log, inner = [], eng._expert_replica

    def replica(ei, slot):
        log.append((ei, slot))
        return inner(ei, slot)

    eng._expert_replica = replica
    return log


# --------------------------------------------------------- the mesh

def meshless(s, parts) -> dict:
    """The meshless engine's Results on the test clock, with its decision
    calls and router batches, for ``serve()`` and each of ``parts`` that
    needs a reference (``run``, ``failures``, ``adapt``); and the
    busiest expert of ``serve()``, the one (d) fails."""
    from repro_torch.serving import ExpertHealth
    base = {}
    for part in ("serve", "run", "adapt", "failures"):
        if part != "serve" and part not in parts:
            continue
        clock = PhaseClock()
        kw = {"adapt": ADAPT, "failures": {"health": ExpertHealth(
            len(s.lib), now_fn=clock)}}.get(part, {})
        eng = engine(s, clock, **kw)
        with decisions() as calls:
            res = (run(s, eng) if part == "run" else
                   serve(s, eng, clock,
                         fail=base["hot"] if part == "failures" else None))
        base[part] = (res, {"calls": calls,
                            "router_batches": eng.stats.router_batches,
                            "router_version": eng.router_version})
        if part == "serve":
            traffic: dict = {}
            for r in res:
                traffic[r.expert] = traffic.get(r.expert, 0) + 1
            names = [e.name for e in s.lib.experts]
            base["hot"] = names.index(max(traffic, key=traffic.get))
    return base


def mesh_case(torch, s, data: int, model: int, base: dict, devices=None,
              parts=("serve", "run", "failures", "adapt", "throughput"),
              repeats: int = 3) -> dict:
    """Parts (a)-(f) of the module's docstring on one (data, model) mesh
    (``devices``: ``make_host_mesh``'s list, None for the first cards)
    against ``base`` (``meshless``).  Stream k runs on the mesh's k-th
    device (row by row), so on distinct cards a stream is a card.
    Raises on the first failed check; returns what was measured."""
    from repro_torch.device import module_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import ExpertHealth

    on_card = module_device(s.router).type == "cuda"
    platform = "cuda" if on_card else "cpu"
    mk = lambda: make_host_mesh(data, model, devices=devices,  # noqa: E731
                                platform=platform)
    tag = f"({data}, {model})"
    hot = base["hot"]
    names = [e.name for e in s.lib.experts]
    out = {"mesh": f"{data}x{model}",
           "devices": [str(d) for d in mk().devices.reshape(-1)]}

    for part in ("serve", "run"):
        if part not in parts:
            continue
        clock = PhaseClock()
        eng = engine(s, clock, mk())
        log = with_flush_log(eng)
        with card_trace(torch, on_card) as trace, decisions() as calls:
            res = serve(s, eng, clock) if part == "serve" else run(s, eng)
        ref, ref_info = base[part]
        agree = decides_as(s, ref, res, f"{tag} {part}()")
        st = eng.mesh_summary()["streams"]
        # (b) streams
        check(sum(st["flushes"]) == sum(eng.stats.flushes.values()),
              f"{tag} {part}(): stream flushes {st['flushes']} against "
              f"{dict(eng.stats.flushes)}")
        check(len(log) == sum(st["flushes"]),
              f"{tag} {part}(): {len(log)} flushes logged")
        stray = [(names[ei], slot) for ei, slot in log
                 if slot not in eng._expert_streams[ei]
                 or slot % model not in eng.placement.slices_for(ei)]
        check(not stray, f"{tag} {part}(): flushes off their slices {stray}")
        check(model == 1 or sum(f > 0 for f in st["flushes"]) > 1,
              f"{tag} {part}(): stream flushes {st['flushes']}")
        # (c) decisions and launches
        n_score = sum(calls["router_score"].values())
        n_casc = sum(calls["router_cascade"].values())
        scored = eng.stats.router_batches - n_casc
        check(n_score == data * scored,
              f"{tag} {part}(): {n_score} router_score calls for {scored} "
              f"router batches")
        ref_casc = sum(ref_info["calls"]["router_cascade"].values())
        check(n_casc == (0 if data > 1 else ref_casc),
              f"{tag} {part}(): {n_casc} router_cascade calls, meshless "
              f"{ref_casc}")
        check(all(calls["router_score"].get(str(d), 0) > 0
                  for d in eng._data_devices),
              f"{tag} {part}(): router_score calls {calls['router_score']}")
        counts = calls["launches"]
        check(not on_card or (counts["router_score"] == n_score
                              and counts["router_cascade"] == n_casc
                              and counts["flash_attention"] > 0),
              f"{tag} {part}(): launches {counts} for {n_score} + {n_casc} "
              f"decisions")
        per_card = None
        if trace:
            per_card = {k: launches_on(trace, k) for k in
                        ("router_score_kernel", "router_cascade_kernel",
                         "flash_attention_kernel")}
            data_cards = [d.index for d in eng._data_devices]
            check(all(per_card["router_score_kernel"].get(c, 0) > 0
                      for c in data_cards),
                  f"{tag} {part}(): router_score per card "
                  f"{per_card['router_score_kernel']}, data cards "
                  f"{data_cards}")
            fa_cards = {eng._devices[k].index
                        for k, f in enumerate(st["flushes"]) if f}
            check(all(per_card["flash_attention_kernel"].get(c, 0) > 0
                      for c in fa_cards),
                  f"{tag} {part}(): flash_attention per card "
                  f"{per_card['flash_attention_kernel']}, flushing cards "
                  f"{sorted(fa_cards)}")
        out[part] = {**agree,
                     "router_batches": eng.stats.router_batches,
                     "decision_calls": {k: calls[k] for k in
                                        ("router_score", "router_cascade")},
                     "launches": counts, "launches_per_card": per_card,
                     "streams": st}
    if "serve" in parts:
        out["placement"] = eng.mesh_summary()["placement"]

    if "failures" in parts:
        # (d) every flush of the busiest expert fails
        clock = PhaseClock()
        eng = engine(s, clock, mk(),
                     health=ExpertHealth(len(s.lib), now_fn=clock))
        res = serve(s, eng, clock, fail=hot)
        agree = decides_as(s, base["failures"][0], res, f"{tag} failures")
        st = eng.mesh_summary()["streams"]
        mine = set(eng._expert_streams[hot])
        fails = eng.stats.expert_failures.get(names[hot], 0)
        check(fails > 0
              and sum(f for i, f in enumerate(st["failures"]) if i in mine)
              == fails
              and not any(f for i, f in enumerate(st["failures"])
                          if i not in mine),
              f"{tag} failures: {st['failures']} on the streams, {fails} "
              f"flushes of {names[hot]} failed, its streams {sorted(mine)}")
        check(not any(r.failed for r in res),
              f"{tag} failures: a request failed outright")
        out["failures"] = {"busiest": names[hot], "expert_failures": fails,
                           "reroutes": eng.stats.reroutes,
                           **agree,
                           "stream_failures": st["failures"]}

    if "adapt" in parts and data > 1:
        out["adapt"] = adapt_case(torch, s, mk(), base, tag)

    if "throughput" in parts:
        out["throughput"] = throughput(torch, s, mk, devices, platform,
                                       repeats, on_card, tag)
    return out


def adapt_case(torch, s, mesh, base, tag) -> dict:
    """(e): the adapting engine on ``mesh`` against the meshless one; then
    every data card's router replica against the live router."""
    from repro_torch.core.router import predict_losses
    ref, info = base["adapt"]
    clock = PhaseClock()
    eng = engine(s, clock, mesh, **ADAPT)
    res = serve(s, eng, clock)
    check(eng.router_version == info["router_version"] > 1,
          f"{tag} adapt: router version {eng.router_version}, meshless "
          f"{info['router_version']}")
    agree = decides_as(s, ref, res, f"{tag} adapt")
    replicas = eng._mesh_router_params()
    live = eng.router_params
    probe = torch.from_numpy(np.stack([r.tokens for r in
                                       s.requests()[:s.max_batch]]))
    with torch.inference_mode():
        want = predict_losses(live, s.rc, {"tokens": probe.to(eng.device)})
        first = predict_losses(s.router, s.rc,
                               {"tokens": probe.to(eng.device)})
        errs, moved = [], float((want - first).abs().max())
        for dev, rep in zip(eng._data_devices, replicas):
            check(next(rep.parameters()).device == dev,
                  f"{tag} adapt: the replica for {dev} lives on "
                  f"{next(rep.parameters()).device}")
            same = all(torch.equal(p.to(eng.device), q) for p, q in
                       zip(rep.parameters(), live.parameters()))
            check(same, f"{tag} adapt: the replica on {dev} holds other "
                        f"weights than version {eng.router_version}")
            got = predict_losses(rep, s.rc, {"tokens": probe.to(dev)})
            errs.append(float((got.to(eng.device) - want).abs().max()))
    check(max(errs) <= ROUTER_TOL < moved,
          f"{tag} adapt: replicas predict within {errs} of the live "
          f"router, which moved {moved} from the first version")
    return {"router_version": eng.router_version,
            "updates": eng.stats.adapt_updates,
            "replica_cache_version": eng._mesh_rp_cache[0],
            "replica_max_abs_err": errs, "moved_from_first": moved,
            **agree}


def throughput(torch, s, mk, devices, platform, repeats, on_card,
               tag) -> dict:
    """(f): host-clock req/s of ``run()`` and ``serve()`` for meshless,
    (1, 1) and the mesh, medians of ``repeats`` after ``warm_mesh``
    (engines built anew each time, one untimed pass of each first); one
    more profiled ``serve()`` of each for the cards' busy shares."""
    from repro_torch.launch.mesh import make_host_mesh
    seq = len(s.requests()[0].tokens)
    n = len(s.requests())
    configs = {"meshless": lambda: None,
               "1x1": lambda: make_host_mesh(1, 1, devices=devices and
                                             devices[:1], platform=platform),
               "mesh": mk}
    walls = {(c, d): [] for c in configs for d in ("run", "serve")}
    spans = {c: [] for c in ("1x1", "mesh")}
    streams = {}
    for rep in range(repeats + 1):
        for name, make in configs.items():
            for disc in ("run", "serve"):
                eng = engine(s, time.monotonic, make())
                eng.warm_mesh(seq)
                if on_card:
                    sync_all(torch)
                t0 = time.perf_counter()
                run(s, eng) if disc == "run" else serve(s, eng)
                if on_card:
                    sync_all(torch)
                if rep == 0:
                    continue            # the untimed pass
                walls[name, disc].append(time.perf_counter() - t0)
                if disc == "serve" and name in spans:
                    spans[name].append(eng.streams.makespan_s)
                if name == "mesh":
                    # every card works: it flushes, or it leads a data row
                    # (devices[r, 0]) and decides that row's block
                    streams[disc] = eng.mesh_summary()["streams"]
                    model = eng.mesh.shape["model"]
                    idle = [k for k, f in enumerate(streams[disc]["flushes"])
                            if not f and k % model]
                    check(not idle, f"{tag} host clock {disc}(): streams "
                                    f"{idle} did no work, flushes "
                                    f"{streams[disc]['flushes']}")
    med = {f"{c}/{d}": float(np.median(v)) for (c, d), v in walls.items()}
    busy = {}
    if on_card:
        for name in ("meshless", "mesh"):
            eng = engine(s, time.monotonic, configs[name]())
            eng.warm_mesh(seq)
            sync_all(torch)
            with card_trace(torch, True) as trace:
                serve(s, eng)
            wall_ms = med[f"{name}/serve"] * 1e3
            busy[name] = {f"cuda:{c}": t["busy_ms"] / wall_ms
                          for c, t in sorted(trace.items())} or None
    return {"req_per_s": {k: n / v for k, v in med.items()},
            "runs_s": {f"{c}/{d}": v for (c, d), v in walls.items()},
            "makespan_speedup_over_1x1": float(np.median(
                [a / b for a, b in zip(spans["1x1"], spans["mesh"])])),
            "wall_speedup_over_meshless": {
                d: med[f"meshless/{d}"] / med[f"mesh/{d}"]
                for d in ("run", "serve")},
            "busy_share": busy or None, "streams": streams}


# ------------------------------------------------ kernels on each card

def kernels_on_cards(torch, cpu: bool) -> dict:
    """Each serving kernel on every visible card (``cuda:0`` current)
    against the plain version on that card and ``cuda:0``'s output, and
    the host cost of a ``router_score_fused`` call on each card."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.router_cascade import ops as rc_ops
    from repro_torch.kernels.router_score import ops as rs_ops

    cards = (["cpu"] if cpu else
             [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    shapes = KERNEL_SHAPES["cpu" if cpu else "card"]
    g = torch.Generator().manual_seed(0)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g) * scale  # noqa
    cases = []
    for B, d, hh, M, n_c in shapes["heads"]:
        t = {"emb": r(B, d), "w1": r(d, hh, scale=d ** -0.5),
             "b1": r(hh, scale=0.1), "w2": r(hh, M, scale=hh ** -0.5),
             "b2": r(M, scale=0.1), "uw1": r(d, hh, scale=d ** -0.5),
             "ub1": r(hh, scale=0.1), "uw2": r(hh, M, scale=hh ** -0.5),
             "ub2": r(M, scale=0.1), "cvals": r(n_c, M).abs(),
             "lam": r(B, n_c).abs(),
             "ladder": torch.randperm(M, generator=g).to(torch.int32)}
        score = ("emb", "w1", "b1", "w2", "b2", "cvals", "lam")
        casc = score[:5] + ("uw1", "ub1", "uw2", "ub2", "cvals", "lam",
                            "ladder")
        # the constrained scores a choice is taken from: the plain
        # predicted losses plus lambda @ constraint values
        scores = (lambda on, want, names:
                  want[0] + on[names.index("lam")] @ on[names.index("cvals")])
        cases.append((f"router_score B={B}", rs_ops.router_score_fused,
                      rs_ops.router_score_plain, [t[k] for k in score],
                      "router", lambda on, want, n=score: scores(on, want, n)))
        cases.append((f"router_cascade B={B}",
                      rc_ops.router_score_cascade_fused,
                      rc_ops.router_cascade_plain, [t[k] for k in casc],
                      "router", lambda on, want, n=casc: scores(on, want, n)))
    for B, S, H, KV, hd, causal, dtype in shapes["attention"]:
        dt = getattr(torch, dtype)
        q = r(B, S, H, hd).to(dt)
        k, v = r(B, S, KV, hd).to(dt), r(B, S, KV, hd).to(dt)
        cases.append((f"flash_attention {dtype} B={B} S={S} H={H} KV={KV} "
                      f"hd={hd}",
                      lambda q, k, v, c=causal: fa_ops.flash_attention(
                          q, k, v, causal=c),
                      lambda q, k, v, c=causal: fa_ops.attention_plain(
                          q, k, v, causal=c), [q, k, v], dtype, None))

    out = {"cards": cards, "cases": []}
    for name, fn, plain, args, kind, constrained in cases:
        first = None
        rec = {"case": name, "max_abs_err": {}, "bitwise_as_first": {}}
        for card in cards:
            on = [a.to(card) for a in args]
            got = fn(*on)
            got = got if isinstance(got, tuple) else (got,)
            want = plain(*on)
            want = want if isinstance(want, tuple) else (want,)
            errs = []
            for a, b in zip(got, want):
                if a.dtype in (torch.int32, torch.int64):
                    # a choice (or escalation target) may differ from the
                    # plain one only between near-tied experts
                    sc = constrained(on, want).cpu()
                    rows = (a != b).nonzero().flatten().cpu()
                    gap = (sc[rows, a.cpu()[rows].long()]
                           - sc[rows, b.cpu()[rows].long()]).abs()
                    check(bool((gap < CHOICE_GAP).all()),
                          f"{name} on {card}: choices {rows.tolist()} "
                          f"differ from the plain version's")
                    continue
                diff = (a.float() - b.float()).abs()
                if kind == "bfloat16":
                    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
                        a.float().abs(), b.float().abs()).clamp_min(
                        2.0 ** -126))) - 7)
                    errs.append(float(((diff - ATTN_TOL).clamp_min(0)
                                       / ulp).max()))
                else:
                    errs.append(float(diff.max()))
            tol = {"router": ROUTER_TOL, "float32": ATTN_TOL,
                   "bfloat16": 1.0}[kind]
            rec["max_abs_err"][card] = max(errs)
            check(max(errs) <= tol, f"{name} on {card}: error {max(errs)} "
                                    f"past {tol} against the plain version")
            host = [a.cpu() for a in got]
            if first is None:
                first = host
            same = all(torch.equal(a, b) for a, b in zip(host, first))
            rec["bitwise_as_first"][card] = same
            check(same, f"{name} on {card}: not bit for bit {cards[0]}'s")
        if kind == "bfloat16":
            rec["unit"] = "bf16 ulps past 2e-5"
        out["cases"].append(rec)
    # medians of 3 rounds, the cards in turn within each
    rounds = [[call_us(torch, card, shapes["heads"][0]) for card in cards]
              for _ in range(3)]
    out["router_score_call_us"] = {
        card: {k: (None if rounds[0][i][k] is None else
                   float(np.median([r[i][k] for r in rounds])))
               for k in ("events_us", "host_us")}
        | {"current": rounds[0][i]["current"]}
        for i, card in enumerate(cards)}
    return out


def call_us(torch, card, shape, iters=200, warmup=20) -> dict:
    """µs a ``router_score_fused`` call on ``card`` (``cuda:0`` current)
    by CUDA events on that card's stream and by the host clock."""
    from repro_torch.kernels.router_score import ops as rs_ops
    B, d, hh, M, n_c = shape
    g = torch.Generator().manual_seed(1)
    args = [torch.randn(*sz, generator=g).to(card) for sz in
            ((B, d), (d, hh), (hh,), (hh, M), (M,), (n_c, M), (B, n_c))]
    fn = lambda: rs_ops.router_score_fused(*args)  # noqa: E731
    for _ in range(warmup):
        fn()
    cuda = card.startswith("cuda")
    if cuda:
        stream = torch.cuda.current_stream(card)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(card)
        start.record(stream)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e6
    events = None
    if cuda:
        end.record(stream)
        torch.cuda.synchronize(card)
        events = start.elapsed_time(end) / iters * 1e3
    return {"events_us": events, "host_us": host,
            "current": (not cuda
                        or torch.cuda.current_device() == int(card[5:]))}


# ------------------------------------------------------------- the CLI

def cli_case(mesh: str, extra: list, cpu: bool) -> dict:
    """``python -m repro_torch.launch.serve --mesh ...`` in a process of
    its own: exit 0, every request answered, flushes on more than one
    card.  With ``cpu``, ``main`` in this process with ``--device cpu``,
    which must raise the count error instead."""
    argv = CLI_ARGS + ["--mesh", mesh] + extra
    need = int(np.prod([int(x) for x in mesh.split(",")]))
    if cpu:
        from repro_torch.launch import serve as cli
        try:
            cli.main(argv + ["--device", "cpu"])
            error = None
        except ValueError as e:
            error = str(e)
        check(error is not None and f"needs {need} devices but only 1 is "
                                    f"visible" in error,
              f"--mesh {mesh} --device cpu: {error!r}")
        return {"argv": argv, "count_error": error}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(proc.returncode == 0, f"--mesh {mesh}: exit {proc.returncode}\n"
                                f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    start = max(i for i, ln in enumerate(lines) if ln == "{")
    summary = json.loads("\n".join(lines[start:]))
    eng, ms = summary["engine"], summary["mesh"]
    flushes = ms["streams"]["flushes"]
    cards = [k for k, f in enumerate(flushes) if f]
    check(summary["requests"] == 256 and eng["served"] == 256
          and eng["fallback"]["failed"] == 0,
          f"--mesh {mesh}: {summary['requests']} requests, "
          f"{eng['served']} served, {eng['fallback']['failed']} failed")
    check(sum(flushes) == sum(eng["flushes"].values()) and len(cards) > 1,
          f"--mesh {mesh}: stream flushes {flushes}")
    return {"argv": argv, "exit": proc.returncode,
            "trained_artifacts": "no artifacts" in proc.stdout,
            "seconds": time.perf_counter() - t0,
            "req_per_s": summary["req_per_s"], "served": eng["served"],
            "mean_mlm_loss": summary["mean_mlm_loss"],
            "mesh": ms["mesh"], "placement": ms["placement"],
            "stream_flushes": flushes, "cards_flushed": len(cards)}


# ---------------------------------------------------------- mesh gate

def gate_case(torch, cpu: bool) -> dict:
    """``launch.gates.mesh`` over the visible cards (or four CPU slots):
    its rows, and per mesh size the simulated and wall tokens/s side by
    side.  With ``--cpu`` the scaling gate, read off wall time, is not
    applied."""
    from repro_torch.launch import gates
    devices = ([torch.device("cpu")] * 4 if cpu else
               [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())])
    lib = gates.mesh_library(devices[0])
    router, rc = gates.small_router(len(lib), device=devices[0])
    table = []
    rows = [[n, v, d] for n, v, d in gates.mesh(
        lib, router, rc, devices, timing_gates=not cpu, table=table)]
    return {"devices": [str(d) for d in devices], "rows": rows,
            "sizes": [{"mesh_size": r["mesh_size"],
                       "simulated_tokens_per_s": r["tokens_per_s"],
                       "wall_tokens_per_s": r["tokens"] / r["wall_s"],
                       **{k: r[k] for k in ("tokens", "makespan_s",
                                            "total_busy_s", "wall_s",
                                            "busy_s", "stream_tokens")}}
                      for r in table]}


# --------------------------------------------------------------- main

def attempt(fn, *args, **kw) -> dict:
    t0 = time.perf_counter()
    try:
        out = {"ok": True, **fn(*args, **kw)}
    except Exception:
        out = {"ok": False, "error": traceback.format_exc()[-3000:]}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({k: out[k] for k in ("ok", "seconds")}
                     | {"case": getattr(fn, "__name__", "")}),
          file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs of each engine in (f)")
    ap.add_argument("--cpu", action="store_true",
                    help="repeated CPU slots and a tiny library")
    ap.add_argument("--gate-only", action="store_true",
                    help="run the mesh gate alone")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    shapes = [tuple(int(x) for x in m.split("x")) for m in MESHES]
    card = "cpu"
    if not args.cpu:
        need = 4 if args.gate_only else max(d * m for d, m in shapes)
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise SystemExit(f"needs {need} cards, sees "
                             f"{torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        from repro_torch.kernels import build
        build.library()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    result = {"card": card, "torch": torch.__version__}
    result["gate_mesh"] = attempt(gate_case, torch, args.cpu)
    if args.gate_only:
        return report(result, [result["gate_mesh"]], args.out)
    result["kernels"] = attempt(kernels_on_cards, torch, args.cpu)
    s = setup(torch, args.cpu)
    parts = ("serve", "run", "failures", "adapt", "throughput")
    base = meshless(s, parts)
    result["meshless"] = {"busiest": s.lib.experts[base["hot"]].name,
                          **{p: base[p][1] for p in ("serve", "run", "adapt")}}
    result["meshes"] = []
    for d, m in shapes:
        devices = ["cpu"] * (d * m) if args.cpu else None
        result["meshes"].append(attempt(
            mesh_case, torch, s, d, m, base, devices=devices, parts=parts,
            repeats=args.repeats))
    result["cli"] = [attempt(cli_case, mesh, extra, args.cpu)
                     for mesh, extra in CLI_MESHES]
    return report(result, [result["gate_mesh"], result["kernels"]]
                  + result["meshes"] + result["cli"], args.out)


def report(result: dict, cases: list, out: Path | None) -> int:
    """Print the result (and write it to ``out``); 0 when every case
    held."""
    result["ok"] = all(c["ok"] for c in cases)
    text = json.dumps(result)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)
    print(text)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
