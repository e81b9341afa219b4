"""The reference's four gated serving benches on the port.

``benchmarks/run.py`` of the JAX package gates four serving behaviours;
these generators run the same scenarios through the port's engine and
keep the same gates:

  ``slo``               availability and p99 under bursty arrivals with
                        one expert failing mid-stream (``bench_slo``);
  ``decision_latency``  the one-launch fused cascade against the staged
                        decide/sigma/escalate path, and the launch-config
                        table's router geometry against the default
                        (``bench_decision_latency``);
  ``cascade``           the confidence cascade's accuracy-against-size
                        front against single-shot routing
                        (``bench_cascade``);
  ``mesh``              the Execute stage across mesh sizes 1, 2, 4 and
                        8, its flushes charged to per-device streams
                        (``bench_mesh``).

Each takes its library, router and device (and ``cascade`` a trained
library's corpus) from the caller and reads nothing from disk.  Each
yields ``(name, value, derived)`` rows under the reference's row names,
then, once every row is out, raises ``RuntimeError`` with the
reference's wording when its gate fails.  Where the reference writes a
CSV (``slo``, ``decision_latency``, ``mesh``), its rows go into the
caller's ``table`` list as dicts keyed by the CSV's columns, and no
``*_csv`` row is yielded.  ``timing_gates=False`` skips the gates read
off wall time (fused against staged p50, the tuned geometry, mesh
scaling), which mean something only on the card; the rows are yielded
either way.

``small_library``, ``mesh_library`` and ``small_router`` build the
reference's synthetic libraries and router at its widths, drawn from
seeded ``torch.Generator``s on the given device (``init_model`` and
``init_router``).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.library import ExpertSpec, ModelLibrary, _enc
from repro_torch.core.objective import recency_constraint, size_constraint
from repro_torch.core.router import RouterConfig, init_router
from repro_torch.core.training import calibrate_uncertainty
from repro_torch.data.batching import mlm_batch
from repro_torch.kernels.router_score import ops as rs_ops
from repro_torch.launch import autotune
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import count_params, init_model
from repro_torch.serving import ExpertHealth, Request, TryageEngine
from repro_torch.serving.placement import plan_placement

FLAG_MIX = [{}, {"size": 1.0}, {"size": 8.0}, {"recency": 2.0}]
# quality floor of the cascade gate (benchmarks/run.py MIN_EXPERT_STEPS):
# below it the experts are near-random and the gate means nothing
MIN_EXPERT_STEPS = 60
# bench_mesh's mesh sizes and their (data, model) shapes, and its
# sequence length (also its experts' vocabulary)
MESH_SHAPES = {1: (1, 1), 2: (1, 2), 4: (1, 4), 8: (2, 4)}
MESH_SEQ = 64


# ------------------------------------------------- libraries and router

def _library(specs, device) -> ModelLibrary:
    lib = ModelLibrary(specs)
    for i, e in enumerate(lib.experts):
        e.params = init_model(e.cfg, seed=i, device=device)
        e.n_params = count_params(e.params)
    return lib


def small_library(device=None) -> ModelLibrary:
    """``bench_slo``'s and ``bench_decision_latency``'s three experts
    (``small``, ``mid``, ``big``: widths 32, 48, 64, vocabulary 64)."""
    return _library([
        ExpertSpec("small", _enc("small", 1, 32, 2, 64, 64), {}, 0.5),
        ExpertSpec("mid", _enc("mid", 1, 48, 2, 96, 64), {}, 0.5),
        ExpertSpec("big", _enc("big", 2, 64, 2, 128, 64), {}, 0.9),
    ], device)


def mesh_library(device=None) -> ModelLibrary:
    """``bench_mesh``'s eight experts ``e0``-``e7``: width 32 + 16 (i mod
    4), 1 + i // 4 layers, vocabulary ``MESH_SEQ``."""
    specs = []
    for i in range(8):
        d = 32 + 16 * (i % 4)
        specs.append(ExpertSpec(f"e{i}", _enc(f"e{i}", 1 + i // 4, d, 2,
                                              2 * d, MESH_SEQ), {},
                                0.5 + 0.05 * i))
    return _library(specs, device)


def small_router(n_models: int, uncertainty: bool = False, device=None):
    """The benches' router (width 32, one layer, two heads, ``d_ff`` 64,
    vocabulary 64): ``(router, rc)``."""
    rc = RouterConfig(n_models=n_models, vocab_size=64, num_layers=1,
                      d_model=32, num_heads=2, d_ff=64)
    return init_router(rc, seed=9, uncertainty=uncertainty,
                       device=device), rc


def _constraints(library):
    return [size_constraint(library), recency_constraint(library)]


class _Clock:
    """A clock that moves only when the bench advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


# ----------------------------------------------------------------- slo

def slo(library, router, rc, device=None, table: list | None = None):
    """Routing availability and p99 under bursty arrivals with one
    expert failing mid-stream, on a synthetic clock (``bench_slo``).

    Two engines serve the same 192-request stream (bursts of 24 at
    0.5 ms gaps alternating with 10 ms gaps; the clock advances only in
    the arrival generator, so latency is pure queueing delay): one with
    an ``ExpertHealth`` and ``fallback_max_depth=2``, one without.  At
    request 64 every flush of the router's most-picked expert starts to
    fail.  Gates: the fallback engine's availability (served /
    admitted) >= 0.99, the baseline's below it, the fallback engine's
    p99 enqueue-to-flush latency <= 5 x ``max_wait_s``.  ``table``
    gets the per-window availabilities (windows of 32 by uid)."""
    cons = _constraints(library)
    n, W = 192, 32
    max_wait = 0.05
    slo_s = 5 * max_wait
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 64, size=(n, 64)).astype(np.int32)

    def workload():
        return [Request(uid=i, tokens=toks[i],
                        lambdas=FLAG_MIX[i % len(FLAG_MIX)])
                for i in range(n)]

    sched_t, t = [], 0.0
    for i in range(n):
        t += 0.0005 if (i // 24) % 2 == 0 else 0.01
        sched_t.append(t)
    fail_at = n // 3

    def run(with_fallback: bool):
        clock = _Clock()
        health = (ExpertHealth(len(library), now_fn=clock)
                  if with_fallback else None)
        eng = TryageEngine(library, router, rc, cons, max_batch=32,
                           max_wait_s=max_wait, decision_cache=False,
                           health=health, fallback_max_depth=2,
                           now_fn=clock, device=device)
        _, warm = eng._score_batch(workload()[:W])
        E = int(np.bincount(np.asarray(warm), minlength=len(library))
                .argmax())

        def arrivals():
            for i, (r, due) in enumerate(zip(workload(), sched_t)):
                while clock.t < due:
                    clock.t = min(clock.t + 0.005, due)
                    yield None
                r.arrival = clock.t
                if i == fail_at:
                    eng.scheduler.inject_failures(E)
                yield r

        return eng, sorted(eng.serve(arrivals()), key=lambda r: r.uid), E

    eng_fb, res_fb, E = run(with_fallback=True)
    eng_nf, res_nf, E_nf = run(with_fallback=False)
    if E != E_nf or not len(res_fb) == len(res_nf) == n:
        raise RuntimeError(f"slo: the two engines failed experts {E} and "
                           f"{E_nf}, answered {len(res_fb)} and "
                           f"{len(res_nf)} of {n} requests")

    def avail(results):
        return 1.0 - sum(r.failed for r in results) / len(results)

    if table is not None:
        for w in range(n // W):
            table.append({
                "window": w,
                "fallback_avail": avail([r for r in res_fb
                                         if r.uid // W == w]),
                "nofallback_avail": avail([r for r in res_nf
                                           if r.uid // W == w])})
    a_fb, a_nf = avail(res_fb), avail(res_nf)
    p99 = float(np.percentile(np.asarray(eng_fb.stats.latencies), 99))
    st = eng_fb.stats
    yield ("slo/failed_expert", float(E), library.experts[E].name)
    yield ("slo/fallback_availability", a_fb, "must be >= 0.99")
    yield ("slo/nofallback_availability", a_nf,
           "must degrade below the fallback engine")
    yield ("slo/fallback_p99_latency_s", p99,
           f"synthetic clock; SLO {slo_s:g}s")
    yield ("slo/fallbacks", float(st.fallbacks), "route-time re-selections")
    yield ("slo/reroutes", float(st.reroutes), "failed-flush re-routes")
    yield ("slo/degraded", float(st.degraded), "")
    yield ("slo/failed_requests", float(st.failed), "")
    yield ("slo/nofallback_failed", float(eng_nf.stats.failed), "")
    if a_fb < 0.99:
        raise RuntimeError(
            f"slo: fallback engine availability {a_fb:.4f} < 0.99")
    if a_nf >= a_fb:
        raise RuntimeError(
            f"slo: no-fallback baseline did not degrade "
            f"(fallback={a_fb:.4f}, nofallback={a_nf:.4f}) — the failure "
            f"injection is not biting")
    if p99 > slo_s:
        raise RuntimeError(
            f"slo: fallback p99 latency {p99:.4f}s exceeds the "
            f"{slo_s:g}s SLO")


# ---------------------------------------------------- decision_latency

def latency_probe(rng) -> list[Request]:
    """The 256 probe requests whose median confidence sets the
    escalation threshold (tokens drawn one request at a time, as the
    reference draws them)."""
    return [Request(uid=i, tokens=rng.integers(4, 64, size=32)
                    .astype(np.int32)) for i in range(256)]


def latency_workload(rng, B: int, thr: float) -> list[Request]:
    """``B`` requests of 32 tokens; odd rows carry the threshold."""
    toks = rng.integers(4, 64, size=(B, 32)).astype(np.int32)
    return [Request(uid=i, tokens=toks[i],
                    min_confidence=thr if i % 2 else 0.0)
            for i in range(B)]


def median_confidence(engine: TryageEngine, reqs: list[Request]) -> float:
    """The median of the router's confidence in each request's first
    pick, plus 1e-6: the threshold that escalates about half of them."""
    _, choice = engine._score_batch(reqs)
    conf = 1.0 / (1.0 + engine._sigma_batch(reqs))
    return float(np.quantile([conf[j, c] for j, c in enumerate(choice)],
                             0.5)) + 1e-6


def decision_latency(library, router, rc, device=None,
                     batches=(1000, 4000, 16000), repeats: int = 7,
                     timing_gates: bool = True, table: list | None = None):
    """The one-launch fused cascade (``router_cascade``) against the
    staged path (``router_score``, a second encoder pass for sigma and
    the host walk): p50 / p99 ms of ``_route_admitted`` over
    ``repeats`` calls after one, at each batch of ``batches`` with
    escalation traffic on the odd rows (``bench_decision_latency``).

    Gates: choices and depths bit-identical between the two paths at
    every batch; with ``timing_gates``, the fused p50 below the staged
    one at the largest batch, and where the launch-config table gives
    ``router_score`` another geometry than the default at a batch
    (``decision_plan``'s ``k_groups`` at the autotuner's head shape, the
    counterpart of the reference's ``block_b``), the tuned geometry
    faster than the default at one batch at least (both timed by
    ``autotune.measure_candidate``).  ``table`` gets the p50 / p99 rows
    of both paths."""
    rng = np.random.default_rng(0)

    def engine(fused):
        return TryageEngine(library, router, rc, decision_cache=False,
                            cascade_max_depth=2, fused_cascade=fused,
                            device=device)

    staged, fused = engine(False), engine(True)
    thr = median_confidence(staged, latency_probe(rng))

    def time_path(eng, reqs):
        out = eng._route_admitted(reqs)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = eng._route_admitted(reqs)
            ts.append((time.perf_counter() - t0) * 1e3)
        return out, (float(np.percentile(ts, 50)),
                     float(np.percentile(ts, 99)))

    d, hh = autotune.ROUTER["d"], autotune.ROUTER["hh"]
    default_k = rs_ops.default_k_groups(d, -(-hh // rs_ops.CLUSTER))
    speedup_at, tile_speedups = {}, {}
    for B in batches:
        reqs = latency_workload(rng, B, thr)
        (_, c_s, _, d_s, _, _), (s50, s99) = time_path(staged, reqs)
        (_, c_f, _, d_f, _, _), (f50, f99) = time_path(fused, reqs)
        match = float(np.array_equal(c_s, c_f) and np.array_equal(d_s, d_f))
        esc_frac = float((np.asarray(d_s) > 0).mean())
        if table is not None:
            table.append({"batch": B, "path": "staged", "p50_ms": s50,
                          "p99_ms": s99})
            table.append({"batch": B, "path": "fused", "p50_ms": f50,
                          "p99_ms": f99})
        yield (f"decision_latency/staged/b{B}/p50_ms", s50,
               f"p99={s99:.4f};esc_frac={esc_frac:.3f}")
        yield (f"decision_latency/fused/b{B}/p50_ms", f50,
               f"p99={f99:.4f}")
        yield (f"decision_latency/b{B}/choice_match", match,
               "choices+depths, fused vs staged, must be 1")
        speedup_at[B] = s50 / f50 if f50 > 0 else float("inf")
        yield (f"decision_latency/b{B}/speedup_p50", speedup_at[B],
               "staged_p50 / fused_p50")
        if not match:
            raise RuntimeError(
                f"decision_latency: fused cascade choices/depths "
                f"diverged from staged path at batch {B}")

        # the table's geometry against the default, on the autotuner's
        # own workload (the shape a table entry is a claim about)
        tuned = rs_ops.decision_plan(B, d, hh)["k_groups"]
        cands = autotune.KERNELS["router_score"][0](
            B, np.random.default_rng(B)).candidates
        by_k = {c.params["k_groups"]: c for c in cands}
        if tuned != default_k and tuned in by_k and default_k in by_k:
            default_ms = autotune.measure_candidate(by_k[default_k],
                                                    repeats) * 1e3
            tuned_ms = autotune.measure_candidate(by_k[tuned], repeats) * 1e3
            tile_speedups[B] = default_ms / tuned_ms
            yield (f"decision_latency/b{B}/tuned_tile_speedup",
                   tile_speedups[B],
                   f"k_groups {tuned} vs {default_k}; "
                   f"default={default_ms:.4f}ms")
        else:
            yield (f"decision_latency/b{B}/tuned_tile_speedup", 1.0,
                   f"effective k_groups {tuned}; no distinct candidate pair")

    if not timing_gates:
        return
    big = max(batches)
    if speedup_at[big] <= 1.0:
        raise RuntimeError(
            f"decision_latency: fused cascade p50 did not beat the "
            f"staged path at batch {big} "
            f"(speedup {speedup_at[big]:.3f}x)")
    if tile_speedups and max(tile_speedups.values()) <= 1.0:
        raise RuntimeError(
            "decision_latency: autotuned tile beat the default "
            f"k_groups={default_k} at no batch point — regenerate the "
            "table with: python -m repro_torch.launch.autotune")


# ------------------------------------------------------------- cascade

def cascade(library, router, rc, corpus, expert_steps: int, device=None,
            calibration=None):
    """Cascade routing against single-shot on the 256-request mixed-flag
    workload over a trained library: the accuracy-against-mean-size
    front (``bench_cascade``).

    Single-shot points add a size penalty lambda of 0, 1, 4 and 8 to the
    mixed flags; cascade points fix lambda 8 and escalate (up to depth
    3) the requests whose first pick's confidence is under the
    workload's own q25 / q50 / q75 / q100 confidence quantile.  Gate:
    some cascade point strictly dominates some single-shot point (>=
    accuracy at <= mean size, strict in one).  ``expert_steps``: the
    library's training steps, which must reach ``MIN_EXPERT_STEPS``.  A
    router without an uncertainty head is given one first by
    ``calibrate_uncertainty`` on ``calibration`` (tokens, per-expert
    losses), as the reference does with its test Q-table."""
    if expert_steps < MIN_EXPERT_STEPS:
        raise RuntimeError(
            f"cascade: the artifacts were generated with "
            f"expert_steps={expert_steps} < {MIN_EXPERT_STEPS} (below the "
            f"fast config) — the gate is meaningless at that quality")
    if router.unc is None:
        if calibration is None:
            raise ValueError("cascade: a router without an uncertainty "
                             "head needs calibration=(tokens, losses)")
        router = calibrate_uncertainty(router, rc, *calibration)
    cons = _constraints(library)
    sizes = {e.name: e.n_params for e in library.experts}
    max_size = max(sizes.values())

    n = 256
    rng = np.random.default_rng(0)
    uniform = {d: 1.0 / 8 for d in corpus.tables}
    toks, _ = corpus.sample_mixture(uniform, n, 128, rng)
    mb = mlm_batch(toks, rng, 0.15, corpus.vocab_size)

    def workload(extra_size_lam=0.0, min_conf=0.0):
        reqs = []
        for i in range(n):
            lam = dict(FLAG_MIX[i % len(FLAG_MIX)])
            if extra_size_lam:
                lam["size"] = lam.get("size", 0.0) + extra_size_lam
            reqs.append(Request(
                uid=i, tokens=mb["tokens"][i], targets=mb["targets"][i],
                mask=mb["mask"][i], lambdas=lam, min_confidence=min_conf))
        return reqs

    eng = TryageEngine(library, router, rc, cons, max_batch=32,
                       cascade_max_depth=3, device=device)

    def run_point(reqs):
        eng.stats = type(eng.stats)()
        eng.cache = type(eng.cache)(eng.cache.capacity)
        for r in reqs:
            eng.submit(r)
        results = eng.run()
        accs = [r.accuracy for r in results if r.accuracy is not None]
        msize = np.mean([sizes[r.expert] for r in results]) / max_size
        return float(np.mean(accs)), float(msize), eng.stats

    single, casc = [], []
    for lam in (0.0, 1.0, 4.0, 8.0):
        acc, msize, _ = run_point(workload(extra_size_lam=lam))
        single.append((acc, msize))
        yield (f"cascade/single_shot/lam_{lam:g}/accuracy", acc,
               f"mean_size_frac={msize:.4f}")

    base = workload(extra_size_lam=8.0)
    confs = []
    for i in range(0, n, 32):
        chunk = base[i:i + 32]
        _, choice = eng._score_batch(chunk)
        conf = 1.0 / (1.0 + eng._sigma_batch(chunk))
        confs.extend(float(conf[j, c]) for j, c in enumerate(choice))
    quants = {"q25": 0.25, "q50": 0.5, "q75": 0.75, "q100": 1.0}
    for qname, q in quants.items():
        t = float(np.quantile(confs, q)) + 1e-6
        acc, msize, stats = run_point(
            workload(extra_size_lam=8.0, min_conf=t))
        casc.append((acc, msize))
        hist = ";".join(f"d{k}:{v}" for k, v in
                        sorted(stats.cascade_depth_hist.items()))
        yield (f"cascade/cascade/{qname}/accuracy", acc,
               f"mean_size_frac={msize:.4f};threshold={t:.4f}")
        yield (f"cascade/cascade/{qname}/escalations",
               float(stats.escalations), hist)

    witness = ""
    dominates = 0.0
    for ca, cs in casc:
        for sa, ss in single:
            if ca >= sa and cs <= ss and (ca > sa or cs < ss):
                dominates = 1.0
                witness = (f"cascade({ca:.4f};{cs:.4f}) beats "
                           f"single({sa:.4f};{ss:.4f})")
                break
        if dominates:
            break
    yield ("cascade/dominates_single_shot", dominates,
           witness or "no dominating operating point")
    if not dominates:
        raise RuntimeError(
            "cascade front does not dominate any single-shot point")


# ---------------------------------------------------------------- mesh

def mesh(library, router, rc, devices, timing_gates: bool = True,
         table: list | None = None):
    """The Execute stage across mesh sizes (``bench_mesh``): one engine
    per size (1, 2, 4: ``(1, k)``; 8: ``(2, 4)``, so the data-parallel
    decision runs too) serves the same 256-request mixed-flag workload
    of ``MESH_SEQ`` tokens.  Placement is traffic-aware (``plan_placement`` over
    each expert's parameters times its share of a routing prescan) with
    the two most-loaded experts on every slice; ``lane_target=8``,
    ``max_wait_s=10``.  Each size serves once to warm up, runs
    ``warm_mesh``, zeroes its ``StreamClock`` and serves again, timed.

    ``devices``: the devices a mesh may use, in order, repeats allowed
    (one card's slots: ``["cuda:0"] * 8``); the first is the engines'
    device, where the library and router live.  A size past ``len(devices)`` is skipped with a row
    saying so.  Throughput is simulated: tokens over the busiest
    stream's busy seconds (each flush's wall time charged to its
    stream).  Gates: choices identical across sizes; with
    ``timing_gates``, size 4's tokens/s >= 3x size 1's.  ``table`` gets
    a row per size (the reference's CSV columns, plus each stream's busy
    seconds and the choices by uid)."""
    devices = list(devices)
    cons = _constraints(library)
    M, n, S = len(library), 256, MESH_SEQ
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 64, size=(n, S)).astype(np.int32)

    def workload():
        return [Request(uid=i, tokens=toks[i],
                        lambdas=FLAG_MIX[i % len(FLAG_MIX)])
                for i in range(n)]

    scout = TryageEngine(library, router, rc, cons, max_batch=32,
                         decision_cache=False, device=devices[0])
    w = workload()
    picks = np.concatenate([scout._score_batch(w[i:i + 32])[1]
                            for i in range(0, n, 32)])
    traffic = np.bincount(picks, minlength=M) / float(n)
    params = [e.n_params for e in library.experts]

    runnable = [k for k in MESH_SHAPES if k <= len(devices)]
    for k in sorted(set(MESH_SHAPES) - set(runnable)):
        yield (f"mesh/size{k}_skipped", 1.0,
               f"needs {k} devices, have {len(devices)}")

    tput, choices = {}, {}
    for k in runnable:
        data, model = MESH_SHAPES[k]
        placement = plan_placement(params, model, replicate_hot=2,
                                   traffic=traffic)
        eng = TryageEngine(library, router, rc, cons, max_batch=32,
                           decision_cache=False, lane_target=8,
                           max_wait_s=10.0,
                           mesh=make_host_mesh(data, model,
                                               devices=devices[:k]),
                           placement=placement, device=devices[0])
        list(eng.serve(iter(workload())))
        eng.warm_mesh(S)
        eng.streams.reset()
        t0 = time.perf_counter()
        results = list(eng.serve(iter(workload())))
        wall = time.perf_counter() - t0
        if len(results) != n:
            raise RuntimeError(f"mesh: size {k} answered {len(results)} "
                               f"of {n} requests")
        choices[k] = [r.expert for r in sorted(results,
                                               key=lambda r: r.uid)]
        st = eng.streams
        tokens = sum(st.tokens)
        tput[k] = tokens / st.makespan_s
        if table is not None:
            table.append({"mesh_size": k, "streams": st.n_streams,
                          "tokens": tokens, "makespan_s": st.makespan_s,
                          "total_busy_s": st.total_busy_s,
                          "tokens_per_s": tput[k], "wall_s": wall,
                          "busy_s": list(st.busy_s),
                          "stream_tokens": list(st.tokens),
                          "choices": choices[k]})
        yield (f"mesh/size{k}_tokens_per_s", tput[k],
               f"simulated overlap, {data}x{model} mesh")
        yield (f"mesh/size{k}_makespan_s", st.makespan_s, "busiest stream")

    base = runnable[0]
    match = float(all(choices[k] == choices[base] for k in runnable))
    yield ("mesh/choice_match", match, "across mesh sizes, must be 1")
    if match != 1.0:
        raise RuntimeError("mesh: routing choices diverged across mesh "
                           "sizes — placement must never change routing")
    if 4 in tput and 1 in tput:
        ratio = tput[4] / tput[1]
        yield ("mesh/scaling_4x", ratio, "size 4 vs 1, must be >= 3")
        if timing_gates and ratio < 3.0:
            raise RuntimeError(
                f"mesh: simulated flushed-tokens/s at mesh size 4 is "
                f"only {ratio:.2f}x size 1 (need >= 3x)")
