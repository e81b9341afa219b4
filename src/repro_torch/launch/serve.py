"""Serving driver of the port: bring up a ``TryageEngine`` on the card
over the trained library and drive it with a Poisson arrival simulator.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 256 \
      [--device cuda|cpu] [--no-buckets] [--fifo] [--arrival-rate 200] \
      [--max-wait-s 0.05] [--priority-mix 0.9,0.08,0.02] \
      [--cascade 0.6] [--cascade-depth 2] [--fused-cascade] \
      [--speculate] \
      [--adapt-every 16 --adapt-lr 0.05 --replay-cap 1024] \
      [--drift-after 128 --drift-domains github,dm_math] \
      [--sessions 4 --admission-cap 256] [--fallback-depth 2] \
      [--fail-expert small --fail-after 64] \
      [--cache-tiers exact,persistent,semantic --cache-dir cache/ \
       --cache-semantic 0.5] \
      [--metrics-port 9109] [--metrics-out metrics.prom] \
      [--tile-table PATH] [--sanitize] [--mesh 1,1 --replicate-hot 1]

The port of ``repro.launch.serve``: the same flags, checks, request
stream (``default_rng(0)``, the corpus's uniform domain mix, MLM masks,
the four-flag lambda mix, priorities) and summary JSON, which ``main``
also returns.  By default requests flow through ``TryageEngine.serve``,
the continuous-batching scheduler; ``--fifo`` drains them with
``run()`` instead.  ``--arrival-rate`` is the Poisson arrival intensity
in requests/second (0 = all at once); ``--sessions N`` multiplexes the
stream over N client sessions through the front end's bounded
admission queue.

The engine runs on ``--device``, by default the card: without a CUDA
device the command raises instead of serving on the CPU, which it does
only when asked (``--device cpu``).  Decisions always go through the
port's kernels (the JAX engine's ``use_kernel=True``), so
``--use-kernel`` is accepted and changes nothing, and ``--fused-cascade``
needs only ``--cascade``.  Artifacts come from
``repro_torch.core.experiment.load_artifacts()``
(``experiments/tryage_torch/``); without them the reduced experiment of
the JAX driver is trained on the device first.  A router without an
uncertainty head gets one calibrated on the held-out Q-table when
``--cascade`` asks for it.

Cache tiers: ``--cache-tiers`` picks the live decision-cache tiers
(``exact``, the in-process LRU, is always on; ``persistent`` adds the
restart-safe disk KV under ``--cache-dir``, whose log a JAX engine can
share; ``semantic`` adds the router-embedding nearest-neighbour tier
with distance bound ``--cache-semantic EPS``).

``--sanitize`` turns on the kernels' sanitizer (``kernels.sanitize``:
NaN/inf and out-of-range checks of the routing path, the switch
``REPRO_SANITIZE=1`` sets); ``--tile-table PATH`` points the kernels'
launch geometry at a launch-config table (``kernels.tiles``, written on
the card by ``python -m repro_torch.launch.autotune``).

``--mesh DATA,MODEL`` serves on a (data, model) mesh
(``launch.mesh.make_host_mesh``) over the first DATA x MODEL visible
devices of ``--device``'s kind: decision batches split over DATA
devices, experts placed on MODEL slices, ``--replicate-hot K`` of them
on every slice.  Every (expert, replica, bucket) variant is run once
before serving (``warm_mesh``), and the summary's ``"mesh"`` block
holds the placement and the per-device streams.  A mesh larger than the
visible devices raises the count error: one card backs only ``--mesh
1,1``, and so does ``--device cpu``; nothing falls back to another
device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def poisson_arrivals(reqs, rate: float, rng,
                     now_fn=time.monotonic, sleep_fn=time.sleep):
    """Yield ``reqs`` with exponential inter-arrival gaps at ``rate``
    req/s, emitting ``None`` idle ticks while waiting so the engine's
    scheduler can fire deadline flushes between arrivals.  ``rate <= 0``
    yields everything back-to-back (a closed-loop benchmark)."""
    if rate <= 0:
        yield from reqs
        return
    t_next = now_fn()
    for r in reqs:
        t_next += rng.exponential(1.0 / rate)
        while now_fn() < t_next:
            yield None
            remaining = t_next - now_fn()
            if remaining > 0:
                sleep_fn(min(remaining, 1e-3))
        r.arrival = now_fn()
        yield r


def parse_priority_mix(spec: str) -> list[float]:
    """'0.9,0.08,0.02' -> normalized fractions for priorities 0,1,2."""
    fracs = [float(x) for x in spec.split(",") if x.strip()]
    total = sum(fracs)
    if not fracs or total <= 0:
        return [1.0]
    return [f / total for f in fracs]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve the trained Tryage library on the card.")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to serve on (default: the current "
                         "CUDA device; raises without one)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for the JAX driver's command lines; "
                         "the port always decides through its kernels")
    ap.add_argument("--no-buckets", action="store_true",
                    help="disable power-of-two expert micro-batch padding")
    ap.add_argument("--fifo", action="store_true",
                    help="FIFO drain instead of the continuous-batching "
                         "scheduler")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival intensity, req/s (0 = all at once)")
    ap.add_argument("--max-wait-s", type=float, default=0.05,
                    help="lane deadline before a partial bucket flushes")
    ap.add_argument("--lane-target", type=int, default=None,
                    help="lane occupancy that flushes a full bucket "
                         "(default: bucket_size(max_batch))")
    ap.add_argument("--priority-mix", type=str, default="0.9,0.08,0.02",
                    help="comma fractions of requests at priority 0,1,2,...")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the router-decision cache")
    ap.add_argument("--cache-tiers", type=str, default="exact",
                    help="comma list of decision-cache tiers: exact "
                         "(in-process LRU, always on), persistent "
                         "(restart-safe disk KV, needs --cache-dir), "
                         "semantic (embedding NN tier, needs "
                         "--cache-semantic)")
    ap.add_argument("--cache-dir", type=str, default="",
                    help="directory of the persistent cache tier's "
                         "segment log (shared across engine replicas)")
    ap.add_argument("--cache-semantic", type=float, default=0.0,
                    metavar="EPS",
                    help="distance bound of the semantic cache tier "
                         "(0 = off; calibrate with "
                         "serving.semcache.calibrate_eps)")
    ap.add_argument("--cascade", type=float, default=0.0, metavar="T",
                    help="confidence threshold for cascade escalation "
                         "(0 = single-shot routing, the default)")
    ap.add_argument("--cascade-depth", type=int, default=2,
                    help="max escalation steps per request")
    ap.add_argument("--fused-cascade", action="store_true",
                    help="with --cascade, resolve score + confidence + "
                         "depth-1 escalation in one router_cascade "
                         "launch (choices identical to the staged path)")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative escalation: lane every request "
                         "on its router choice immediately and resolve "
                         "the cascade verdict after the tick's flushes "
                         "launch (needs --cascade; incompatible with "
                         "--fallback-depth)")
    ap.add_argument("--tile-table", type=str, default="", metavar="PATH",
                    help="launch-config table of the kernels (default: "
                         "experiments/tryage/tile_table_torch.json or "
                         "$REPRO_TORCH_TILE_TABLE; write one on the card "
                         "with python -m repro_torch.launch.autotune)")
    ap.add_argument("--adapt-every", type=int, default=0, metavar="N",
                    help="router update every N observed losses "
                         "(0 = frozen router, the default)")
    ap.add_argument("--adapt-lr", type=float, default=0.05,
                    help="learning rate of the incremental router update")
    ap.add_argument("--replay-cap", type=int, default=1024,
                    help="bounded feedback replay-buffer capacity")
    ap.add_argument("--drift-after", type=int, default=0, metavar="R",
                    help="switch the domain mix after R requests "
                         "(0 = no drift, the default)")
    ap.add_argument("--drift-domains", type=str, default="github,dm_math",
                    help="comma list of domains the post-shift mix "
                         "concentrates on")
    ap.add_argument("--sessions", type=int, default=0, metavar="N",
                    help="multiplex the stream over N concurrent client "
                         "sessions through the front end's bounded "
                         "admission queue (0 = direct iterator)")
    ap.add_argument("--admission-cap", type=int, default=256,
                    help="front-end admission-queue bound; overflow "
                         "load-sheds the lowest-priority request")
    ap.add_argument("--fallback-depth", type=int, default=0, metavar="D",
                    help="attach a health tracker and walk up to D "
                         "fallback re-selections around unhealthy or "
                         "saturated experts (0 = health-unaware, the "
                         "default)")
    ap.add_argument("--fail-expert", type=str, default="",
                    help="arm a persistent failure injection on this "
                         "expert's lanes (by name) once --fail-after "
                         "requests have been admitted")
    ap.add_argument("--fail-after", type=int, default=0,
                    help="admitted-request count that triggers "
                         "--fail-expert")
    ap.add_argument("--mesh", type=str, default="", metavar="DATA,MODEL",
                    help="serve on a (data, model) device mesh: the "
                         "routing stage splits decision batches over "
                         "DATA devices and experts are placed on MODEL "
                         "slices (needs DATA x MODEL visible devices)")
    ap.add_argument("--replicate-hot", type=int, default=0, metavar="K",
                    help="with --mesh, replicate the K largest experts "
                         "onto every model slice (flushes pick the "
                         "least-busy replica stream)")
    ap.add_argument("--metrics-port", type=int, default=0, metavar="P",
                    help="serve Prometheus text metrics on "
                         "http://127.0.0.1:P/metrics during the run "
                         "(0 = off)")
    ap.add_argument("--metrics-out", type=str, default="",
                    help="write a final metrics scrape to this file")
    ap.add_argument("--sanitize", action="store_true",
                    help="enable the kernels' sanitizer (NaN/inf + "
                         "out-of-range checks on the routing path; same "
                         "switch as REPRO_SANITIZE=1)")
    return ap


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``), serve, print the
    summary JSON and return it as a dict."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.adapt_every > 0 and args.replay_cap <= 0:
        ap.error("--adapt-every needs a replay buffer (--replay-cap >= 1)")
    tiers = {t.strip() for t in args.cache_tiers.split(",") if t.strip()}
    unknown_tiers = tiers - {"exact", "persistent", "semantic"}
    if unknown_tiers:
        ap.error(f"--cache-tiers: unknown tier(s) {sorted(unknown_tiers)} "
                 f"(choose from exact, persistent, semantic)")
    if "persistent" in tiers and not args.cache_dir:
        ap.error("--cache-tiers persistent needs --cache-dir")
    if "semantic" in tiers and args.cache_semantic <= 0:
        ap.error("--cache-tiers semantic needs --cache-semantic EPS > 0")
    if args.no_cache and tiers - {"exact"}:
        ap.error("--no-cache conflicts with --cache-tiers "
                 "persistent/semantic")
    if args.fused_cascade and args.cascade <= 0:
        ap.error("--fused-cascade needs --cascade T > 0")
    if args.speculate and args.cascade <= 0:
        ap.error("--speculate needs --cascade T > 0")
    if args.speculate and (args.fallback_depth > 0 or args.fail_expert):
        ap.error("--speculate is incompatible with the health tracker "
                 "(--fallback-depth/--fail-expert): deferred verdicts "
                 "cannot reorder around the health consult")
    if args.speculate and args.fifo:
        ap.error("--speculate needs the scheduler (drop --fifo)")
    if args.mesh:
        try:
            mdata, mmodel = (int(x) for x in args.mesh.split(","))
        except ValueError:
            ap.error("--mesh expects two integers 'data,model'")
    elif args.replicate_hot:
        ap.error("--replicate-hot needs --mesh")

    if args.tile_table:
        from repro_torch.kernels import tiles
        tiles.set_table_path(args.tile_table)

    if args.sanitize:
        from repro_torch.kernels import sanitize
        sanitize.set_sanitize(True)

    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)     # no card and no --device: raise
    mesh = None
    if args.mesh:
        # over the visible devices of dev's kind; too few raise
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(mdata, mmodel, platform=dev.type)

    from repro_torch.core import experiment as ex
    from repro_torch.core.objective import (recency_constraint,
                                            size_constraint)
    from repro_torch.data.batching import mlm_batch
    from repro_torch.serving import (ExpertHealth, Request,
                                     ServingFrontend, Session, TryageEngine)
    from repro_torch.serving.metrics import render, start_metrics_server

    try:
        art = ex.load_artifacts()
    except FileNotFoundError:
        print("no artifacts; running reduced experiment first", flush=True)
        xc = ex.ExperimentConfig(expert_steps=60, n_train_prompts=512,
                                 n_val_prompts=128, n_test_per_domain=24,
                                 router_epochs=3)
        ex.run_experiment(xc, verbose=True, device=dev)
        art = ex.load_artifacts()

    lib, rp, rc, corpus = (art["library"], art["router_params"], art["rc"],
                           art["corpus"])
    for e in lib.experts:
        e.params = e.params.to(dev)
    rp = rp.to(dev)
    if args.cascade > 0 and rp.unc is None:
        from repro_torch.core.training import calibrate_uncertainty
        print("calibrating uncertainty head on held-out Q-table", flush=True)
        rp = calibrate_uncertainty(rp, rc, art["test_tokens"],
                                   art["q_test"]["loss"])
    health = (ExpertHealth(len(lib))
              if args.fallback_depth > 0 or args.fail_expert else None)
    eng = TryageEngine(lib, rp, rc,
                       [size_constraint(lib), recency_constraint(lib)],
                       max_batch=args.max_batch,
                       buckets=not args.no_buckets,
                       lane_target=args.lane_target,
                       max_wait_s=args.max_wait_s,
                       decision_cache=not args.no_cache,
                       cache_dir=(args.cache_dir
                                  if "persistent" in tiers else None),
                       cache_semantic_eps=(args.cache_semantic
                                           if "semantic" in tiers else 0.0),
                       cascade_max_depth=args.cascade_depth,
                       fused_cascade=args.fused_cascade,
                       speculate=args.speculate,
                       adapt_every=args.adapt_every,
                       adapt_lr=args.adapt_lr,
                       replay_cap=args.replay_cap,
                       health=health,
                       fallback_max_depth=args.fallback_depth,
                       mesh=mesh, replicate_hot=args.replicate_hot,
                       device=dev)
    if mesh is not None:
        # every (expert, replica, bucket) variant once, so that no
        # measured flush pays a replica's first copy or launch
        eng.warm_mesh(args.seq)

    rng = np.random.default_rng(0)
    uniform = {d: 1.0 / 8 for d in corpus.tables}
    # drift simulator: requests [0, drift_after) sample the uniform mix,
    # the rest a mix concentrated on --drift-domains
    n_pre = (min(args.drift_after, args.requests) if args.drift_after > 0
             else args.requests)
    if n_pre < args.requests:
        shift_doms = [d.strip() for d in args.drift_domains.split(",")
                      if d.strip()]
        unknown = set(shift_doms) - set(corpus.tables)
        if not shift_doms or unknown:
            raise SystemExit(f"--drift-domains must name corpus domains "
                             f"(unknown: {sorted(unknown)}; "
                             f"have: {sorted(corpus.tables)})")
        shifted = {d: 1.0 / len(shift_doms) for d in shift_doms}
        t_pre, _ = corpus.sample_mixture(uniform, n_pre, args.seq, rng)
        t_post, _ = corpus.sample_mixture(shifted, args.requests - n_pre,
                                          args.seq, rng)
        toks = np.concatenate([t_pre, t_post])
    else:
        toks, _ = corpus.sample_mixture(uniform, args.requests, args.seq,
                                        rng)
    mb = mlm_batch(toks, rng, 0.15, corpus.vocab_size)
    flag_mix = [{}, {"size": 1.0}, {"size": 8.0}, {"recency": 2.0}]
    mix = parse_priority_mix(args.priority_mix)
    priorities = rng.choice(len(mix), size=args.requests, p=mix)
    reqs = [Request(uid=i, tokens=mb["tokens"][i], targets=mb["targets"][i],
                    mask=mb["mask"][i], lambdas=flag_mix[i % len(flag_mix)],
                    priority=int(priorities[i]),
                    min_confidence=args.cascade)
            for i in range(args.requests)]

    names = [e.name for e in lib]
    fail_idx = None
    if args.fail_expert:
        if args.fail_expert not in names:
            raise SystemExit(f"--fail-expert must be one of {names}")
        if args.fifo:
            ap.error("--fail-expert needs the scheduler (drop --fifo)")
        fail_idx = names.index(args.fail_expert)
    if args.sessions > 0 and args.fifo:
        ap.error("--sessions needs the streaming engine (drop --fifo)")

    # arm the failure injection mid-stream: once --fail-after requests
    # have been admitted, every flush of the target expert's lanes fails
    # until the end of the run
    trigger = {"n": 0, "armed": False}

    def with_failure_trigger(stream):
        for item in stream:
            yield item
            if item is not None:
                trigger["n"] += 1
                if (fail_idx is not None and not trigger["armed"]
                        and trigger["n"] >= args.fail_after):
                    trigger["armed"] = True
                    eng.scheduler.inject_failures(fail_idx)

    srv = None
    if args.metrics_port:
        srv = start_metrics_server(
            args.metrics_port,
            lambda: render(eng.stats, eng.health, names))
        print(f"metrics: http://127.0.0.1:{srv.port}/metrics", flush=True)

    t0 = time.monotonic()
    try:
        if args.fifo:
            for r in reqs:
                eng.submit(r)
            results = eng.run()
        elif args.sessions > 0:
            chunks = [reqs[i::args.sessions] for i in range(args.sessions)]
            sess = [Session(f"s{i}", with_failure_trigger(poisson_arrivals(
                        c, args.arrival_rate / args.sessions, rng)))
                    for i, c in enumerate(chunks)]
            fe = ServingFrontend(eng, sess, capacity=args.admission_cap)
            results = list(fe.serve())
        else:
            arrivals = with_failure_trigger(
                poisson_arrivals(reqs, args.arrival_rate, rng))
            results = list(eng.serve(arrivals))
        dt = time.monotonic() - t0
    finally:
        if srv is not None:
            srv.stop()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(render(eng.stats, eng.health, names))
        print(f"metrics written to {args.metrics_out}", flush=True)
    if hasattr(eng.cache, "close"):       # persist the T2 segment log
        eng.cache.close()
    accs = [r.accuracy for r in results if r.accuracy is not None]
    losses = [r.loss for r in results if r.loss is not None]
    summary = {
        "requests": len(results),
        "router_path": "fused-kernel",
        "discipline": "fifo-drain" if args.fifo else "continuous-batching",
        "cascade_threshold": args.cascade,
        "fused_cascade": args.fused_cascade,
        "speculate": args.speculate,
        "adapt_every": args.adapt_every,
        "sanitize": args.sanitize,
        "drift_after": args.drift_after,
        "arrival_rate": args.arrival_rate,
        "sessions": args.sessions,
        "fallback_depth": args.fallback_depth,
        "fail_expert": args.fail_expert or None,
        "cache_tiers": sorted(tiers) if not args.no_cache else [],
        "mesh": eng.mesh_summary(),
        "device": str(eng.device),
        "wall_s": round(dt, 2),
        "req_per_s": round(len(results) / dt, 1),
        "mean_mlm_accuracy": round(float(np.mean(accs)), 4),
        "mean_mlm_loss": round(float(np.mean(losses)), 4),
        "engine": eng.stats.summary(),
    }
    print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
