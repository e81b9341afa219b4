"""The Tryage serving engine on PyTorch: ``run()`` and ``serve()``.

A port of ``repro.serving.engine.TryageEngine`` over the staged pipeline
(``serving.pipeline``): admission batches of up to ``max_batch``
requests are routed (decision cache, then the router encoder and the
fused decision kernel), cascaded and consulted against the health
tracker.  Two executor disciplines sit on top of the same stages:

  ``run()``    FIFO drain — every admission batch launches its per-expert
               groups at once, however ragged.  The baseline
               ``serve()`` is measured against.
  ``serve()``  continuous batching — per-expert lanes
               (``serving.scheduler``) gather same-expert requests
               across admission batches and flush on a full power-of-two
               bucket or a ``max_wait_s`` deadline, streaming ``Result``s
               back; with ``speculate=True`` the cascade verdict lands
               after the request is already laned on its first pick.
               Failed flushes feed the health tracker
               (``serving.health``) and re-route through the fallback
               chain.

Decisions always take the fused path of the JAX engine's
``use_kernel=True``: the router encoder runs in PyTorch (its attention
through the flash-attention kernel), then ``router_route`` — the
``router_score`` kernel on the card — adds the lambda-weighted
constraints and takes the argmin.  With ``fused_cascade=True`` a batch
that carries cascade traffic (``min_confidence > 0``) is decided by the
one-launch ``router_cascade`` kernel instead, which also returns sigma
and the depth-1 escalation target.  The staged sigma pass and the
cascade's host walk stay plain torch / numpy, as the JAX engine leaves
them to XLA and numpy.

Requests keep their tokens as host numpy int32 arrays (the decision
cache hashes those bytes, identically to the JAX engine); tensors move
to the engine's device only inside the engine.  Expert micro-batches are
padded to power-of-two buckets (``buckets=True``).

Not ported yet: the T2/T3 cache tiers, mesh placement and online
adaptation.  Their knobs are absent from the constructor.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import defaultdict, deque
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.library import ModelLibrary
from repro_torch.core.objective import (Constraint, cascade_choice,
                                        confidence_scores, constraint_matrix,
                                        escalation_order, fallback_choice)
from repro_torch.core.router import (RouterConfig, VersionedParams,
                                     predict_uncertainty, router_embed)
from repro_torch.device import module_device, resolve_device
from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops
from repro_torch.models.model import forward
from repro_torch.serving.cache import DecisionCache
from repro_torch.serving.feedback import ReplayBuffer
from repro_torch.serving.health import ExpertHealth
from repro_torch.serving.pipeline import RouteContext, ServingPipeline
from repro_torch.serving.requests import Request, Result, lambda_matrix
from repro_torch.serving.scheduler import ExpertScheduler, LaneEntry


def bucket_size(n: int) -> int:
    """Smallest power of two >= n — the padded micro-batch shape."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


@dataclasses.dataclass
class EngineStats:
    """The JAX engine's telemetry, field for field, as far as the port
    fills it.  ``cache_tier_hits``, ``cache_revalidations*``,
    ``adapt_updates`` and ``router_version`` belong to features not
    ported yet (the T2/T3 cache tiers, online adaptation); they stay at
    zero, as on a JAX engine with those features off, so that
    ``serving.metrics.render`` reads the same series from both."""

    served: int = 0
    per_expert: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    total_flops: float = 0.0
    router_time_s: float = 0.0
    router_batches: int = 0            # router forward passes launched
    expert_time_s: float = 0.0
    # padded micro-batch size -> launch count, and the padded rows run
    bucket_hits: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    padded_rows: int = 0
    # flush reason -> count, peak lane depth per expert name ("@esc" for
    # escalation lanes), true enqueue->flush latency per request over a
    # bounded window
    flushes: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    lane_peaks: dict = dataclasses.field(default_factory=dict)
    latencies: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=65536))
    cache_hits: int = 0
    cache_misses: int = 0
    cache_tier_hits: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    cache_revalidations: int = 0
    cache_revalidation_rejects: int = 0
    cache_key_dropped_lambda: int = 0
    escalations: int = 0
    cascade_depth_hist: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    tier_latencies: dict = dataclasses.field(
        default_factory=lambda: defaultdict(
            lambda: deque(maxlen=65536)))
    # speculative escalation (serve() with speculate=True); once every
    # verdict has landed, launched == hits + cancelled + wasted
    spec_launched: int = 0
    spec_hits: int = 0
    spec_cancelled: int = 0
    spec_wasted: int = 0
    spec_wasted_tokens: int = 0
    # launch geometry of each decision kernel per padded batch size:
    # {kernel: {Bp: plan}}
    router_tiles: dict = dataclasses.field(default_factory=dict)
    adapt_updates: int = 0
    router_version: int = 0
    feedback_events: int = 0
    feedback_dropped: int = 0
    replay_len: int = 0
    replay_cap: int = 0
    # front end: sessions multiplexed, requests admitted through the
    # bounded queue, load-shed requests (total and per priority), and
    # the queue's peak occupancy
    sessions: int = 0
    admitted: int = 0
    shed: int = 0
    shed_by_priority: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    admission_queue_peak: int = 0
    # health fallback: route-time re-selections (by chain depth, and the
    # degraded subset), failed-flush re-routes, requests failed outright
    # and failed flushes per expert name
    fallbacks: int = 0
    fallback_depth_hist: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    degraded: int = 0
    reroutes: int = 0
    failed: int = 0
    expert_failures: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @staticmethod
    def _pctiles(latencies) -> dict:
        if not latencies:
            return {"p50_s": 0.0, "p95_s": 0.0}
        lat = np.asarray(latencies)
        return {"p50_s": float(np.percentile(lat, 50)),
                "p95_s": float(np.percentile(lat, 95))}

    def latency_percentiles(self) -> dict:
        return self._pctiles(self.latencies)

    def tier_latency_percentiles(self) -> dict:
        """p50/p95 enqueue->flush latency per cascade tier (depth)."""
        return {int(tier): self._pctiles(lat)
                for tier, lat in sorted(self.tier_latencies.items())}

    def summary(self) -> dict:
        return {"served": self.served,
                "per_expert": dict(self.per_expert),
                "total_flops": self.total_flops,
                "router_time_s": round(self.router_time_s, 3),
                "router_batches": self.router_batches,
                "expert_time_s": round(self.expert_time_s, 3),
                "bucket_hits": {int(k): v for k, v in
                                sorted(self.bucket_hits.items())},
                "padded_rows": self.padded_rows,
                "flushes": dict(self.flushes),
                "lane_peaks": dict(self.lane_peaks),
                "latency": {k: round(v, 6) for k, v in
                            self.latency_percentiles().items()},
                "cache": {"hits": self.cache_hits,
                          "misses": self.cache_misses,
                          "hit_rate": round(self.cache_hit_rate, 4),
                          "dropped_lambda":
                              self.cache_key_dropped_lambda},
                "cascade": {
                    "escalations": self.escalations,
                    "depth_hist": {int(k): v for k, v in
                                   sorted(self.cascade_depth_hist.items())},
                    "tier_latency": {
                        tier: {k: round(v, 6) for k, v in p.items()}
                        for tier, p in
                        self.tier_latency_percentiles().items()}},
                "speculation": {
                    "launched": self.spec_launched,
                    "hits": self.spec_hits,
                    "cancelled": self.spec_cancelled,
                    "wasted": self.spec_wasted,
                    "wasted_tokens": self.spec_wasted_tokens},
                "router_tiles": {
                    name: {int(b): dict(plan) for b, plan in
                           sorted(tiles.items())}
                    for name, tiles in sorted(self.router_tiles.items())},
                "feedback": {"events": self.feedback_events,
                             "dropped": self.feedback_dropped,
                             "replay": {"len": self.replay_len,
                                        "cap": self.replay_cap}},
                "frontend": {
                    "sessions": self.sessions,
                    "admitted": self.admitted,
                    "shed": self.shed,
                    "shed_by_priority": {int(k): v for k, v in
                                         sorted(self.shed_by_priority
                                                .items())},
                    "queue_peak": self.admission_queue_peak},
                "fallback": {
                    "fallbacks": self.fallbacks,
                    "depth_hist": {int(k): v for k, v in
                                   sorted(self.fallback_depth_hist
                                          .items())},
                    "degraded": self.degraded,
                    "reroutes": self.reroutes,
                    "failed": self.failed,
                    "expert_failures": dict(self.expert_failures)}}


class TryageEngine:
    """Staged serving pipeline (Route -> Cascade -> Execute -> Feedback)
    over a model library, draining its queue with ``run()`` or streaming
    with ``serve()``.

    ``library`` experts carry their ``Model`` in ``params`` and
    ``router`` is a ``core.router.Router``; both must already live on
    ``device`` (default: the card; raises without one).

    - ``max_batch``: admission-batch size; ``buckets``: pad expert
      micro-batches and decision batches to powers of two.
    - ``decision_cache`` / ``cache_capacity``: the exact LRU of routing
      verdicts.
    - ``cascade_max_depth``: bound on escalation steps; 0 disables the
      cascade.
    - ``fused_cascade``: decide batches with cascade traffic in one
      ``router_cascade`` launch (needs an uncertainty head; otherwise
      the staged path runs).  Depth >= 2 escalations take the staged
      host walk row by row, so verdicts match the staged path.
    - ``lane_target``: lane occupancy that flushes a full micro-batch in
      ``serve()``; defaults to ``bucket_size(max_batch)``, so a target
      flush is a full power-of-two bucket with no padded rows.
    - ``max_wait_s``: deadline for the oldest request in a lane.
    - ``speculate``: in ``serve()``, lane each cascade-eligible request
      on its first pick at once and land the escalation verdict on the
      next scheduler tick (cancelling or discarding the provisional
      entry on escalate).  One Result per request either way; ignored
      with a health tracker and under ``run()``.
    - ``health``: an ``ExpertHealth`` over the library (None: the
      Fallback stage is a strict no-op); ``fallback_max_depth``: bound
      on route-time fallback re-selections per request.
    - ``replay_cap``: feedback replay-buffer capacity (0 disables it).
    - ``now_fn``: engine clock (injectable for deterministic tests).
    """

    def __init__(self, library: ModelLibrary, router: nn.Module,
                 rc: RouterConfig, constraints: Sequence[Constraint] = (),
                 max_batch: int = 16, buckets: bool = True,
                 decision_cache: bool = True, cache_capacity: int = 4096,
                 cascade_max_depth: int = 2, fused_cascade: bool = False,
                 lane_target: int | None = None, max_wait_s: float = 0.05,
                 speculate: bool = False,
                 health: ExpertHealth | None = None,
                 fallback_max_depth: int = 2, replay_cap: int = 4096,
                 now_fn: Callable[[], float] = time.monotonic,
                 device=None):
        if len(library) != rc.n_models:
            raise ValueError(f"library has {len(library)} experts, router "
                             f"scores {rc.n_models}")
        if health is not None and health.n_experts != len(library):
            raise ValueError(f"health tracker sized for {health.n_experts} "
                             f"experts, library has {len(library)}")
        self.device = resolve_device(device)
        for name, module in [("router", router)] + [
                (e.name, e.params) for e in library.experts]:
            if module is None:
                raise ValueError(f"expert {name} has no parameters")
            if module_device(module) != self.device:
                raise ValueError(
                    f"{name} lives on {module_device(module)}, the engine "
                    f"on {self.device}; move it with .to()")
        self.library = library
        self._router = VersionedParams(router, 0)
        self.rc = rc
        self.constraints = list(constraints)
        self.max_batch = max_batch
        self.buckets = buckets
        self.lane_target = (bucket_size(max_batch) if lane_target is None
                            else lane_target)
        self.max_wait_s = max_wait_s
        self.cache = DecisionCache(cache_capacity) if decision_cache else None
        self.cascade_max_depth = cascade_max_depth
        self.fused_cascade = fused_cascade
        self.speculate = speculate
        self.health = health
        self.fallback_max_depth = fallback_max_depth
        # the live ExpertScheduler while serve() runs (the failure
        # injection handle); None before the first serve()
        self.scheduler: ExpertScheduler | None = None
        self._esc_order = escalation_order(library)
        # expert index -> position in the escalation ladder (the inverse
        # permutation the fused cascade kernel consumes)
        self._ladder_pos = np.zeros(len(library), np.int64)
        for pos, e in enumerate(self._esc_order):
            self._ladder_pos[e] = pos
        self._now = now_fn
        self.queue: list[Request] = []
        self.stats = EngineStats()
        self.replay = ReplayBuffer(replay_cap) if replay_cap > 0 else None
        self.pipeline = ServingPipeline(self)
        self._cnames = [c.name for c in self.constraints]
        self._cmat = constraint_matrix(self.constraints, rc.n_models)
        self._cmat_dev = torch.from_numpy(self._cmat).to(self.device)
        self._ladder_dev = torch.from_numpy(
            self._ladder_pos.astype(np.int32)).to(self.device)

    @property
    def router_params(self) -> nn.Module:
        """The live router snapshot."""
        return self._router.params

    @property
    def router_version(self) -> int:
        """Monotone version of the live router snapshot — part of every
        decision-cache key."""
        return self._router.version

    # ------------------------------------------------------------- api

    def submit(self, req: Request):
        if req.arrival is None:
            req.arrival = self._now()
        self.queue.append(req)

    def _bucket(self, n: int) -> int:
        return bucket_size(n) if self.buckets else n

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _padded(self, reqs: list[Request], lam: bool = True):
        """Tokens (and lambdas) of ``reqs`` padded with zero rows to the
        bucket size, on the device."""
        B = len(reqs)
        Bp = self._bucket(B)
        toks = np.zeros((Bp,) + reqs[0].tokens.shape, reqs[0].tokens.dtype)
        toks[:B] = np.stack([r.tokens for r in reqs])
        out = [self._to_device(toks)]
        if lam:
            lm = lambda_matrix(reqs, self._cnames)
            lmp = np.zeros((Bp, lm.shape[1]), np.float32)
            lmp[:B] = lm
            out.append(self._to_device(lmp))
        return Bp, out

    # ---------------------------------------------------- routing stage

    @torch.inference_mode()
    def _score_batch(self, reqs: list[Request]) -> tuple[np.ndarray,
                                                         np.ndarray]:
        """Score one batch with the router (no cache): the predicted
        per-expert losses (B, M) f32 and the chosen expert (B,) under
        each request's lambda-weighted constraints, from one
        ``router_score`` launch after the encoder."""
        B = len(reqs)
        t0 = self._now()
        Bp, (toks, lam) = self._padded(reqs)
        router = self.router_params
        emb = router_embed(router, self.rc, {"tokens": toks})
        pred, choice = rs_ops.router_route(emb, router.head, self._cmat_dev,
                                           lam)
        tiles = self.stats.router_tiles.setdefault("router_score", {})
        if Bp not in tiles:
            tiles[Bp] = rs_ops.decision_plan(Bp, *router.head["w1"].shape)
        pred = pred.cpu().numpy()[:B]
        choice = choice.cpu().numpy()[:B]
        self.stats.router_time_s += self._now() - t0
        self.stats.router_batches += 1
        return pred, choice

    def _use_fused_cascade(self, reqs: list[Request]) -> bool:
        """Whether this batch takes the one-launch cascade decision: the
        flag is on, the cascade is enabled, the router has an
        uncertainty head and the batch carries cascade traffic."""
        return (self.fused_cascade and self.cascade_max_depth > 0
                and self.router_params.unc is not None
                and any(r.min_confidence > 0.0 for r in reqs))

    @torch.inference_mode()
    def _score_cascade_batch(self, reqs: list[Request]) -> tuple[
            np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """One-launch cascade scoring: ``(pred, choice, sigma, esc)``
        from a single ``router_cascade`` launch after the encoder."""
        B = len(reqs)
        t0 = self._now()
        Bp, (toks, lam) = self._padded(reqs)
        router = self.router_params
        emb = router_embed(router, self.rc, {"tokens": toks})
        pred, sigma, choice, esc = rc_ops.router_route_cascade(
            emb, router.head, router.unc, self._cmat_dev, lam,
            self._ladder_dev)
        tiles = self.stats.router_tiles.setdefault("router_cascade", {})
        if Bp not in tiles:
            tiles[Bp] = rc_ops.decision_plan(Bp, *router.head["w1"].shape)
        pred, sigma, choice, esc = (t.cpu().numpy()[:B]
                                    for t in (pred, sigma, choice, esc))
        self.stats.router_time_s += self._now() - t0
        self.stats.router_batches += 1
        return pred, choice, sigma, esc

    @torch.inference_mode()
    def _sigma_batch(self, reqs: list[Request]) -> np.ndarray:
        """Per-expert sigma (B, M): a second router pass, paid only by
        cascade traffic on the staged path."""
        _, (toks,) = self._padded(reqs, lam=False)
        sigma = predict_uncertainty(self.router_params, self.rc,
                                    {"tokens": toks})
        return sigma.cpu().numpy()[:len(reqs)]

    def _cascade(self, reqs: list[Request], pred: np.ndarray,
                 choice: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
        """Staged abstention/escalation pass over a scored batch:
        ``(final_choice, depth, confidence)``.  Batches without a
        confidence floor pass through untouched."""
        B = len(reqs)
        depth = np.zeros(B, np.int64)
        conf = np.ones(B, np.float64)
        if (self.cascade_max_depth <= 0
                or not any(r.min_confidence > 0.0 for r in reqs)):
            return choice, depth, conf
        confm = confidence_scores(self._sigma_batch(reqs))
        # constrained routing scores L-hat + sum_j lambda_j C_j, (B, M)
        scores = pred + lambda_matrix(reqs, self._cnames) @ self._cmat
        final = np.array(choice, np.int64, copy=True)
        for i, r in enumerate(reqs):
            if r.min_confidence <= 0.0:
                continue
            final[i], depth[i] = cascade_choice(
                int(choice[i]), confm[i], r.min_confidence,
                self._esc_order, self.cascade_max_depth, scores[i])
            conf[i] = confm[i, final[i]]
        return final, depth, conf

    def _cascade_fused(self, reqs: list[Request], pred: np.ndarray,
                       choice: np.ndarray, sigma: np.ndarray,
                       esc: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
        """Resolve each request's threshold against the kernel's sigma
        and depth-1 escalation target; a request still under-confident
        after one step (with ladder left and ``cascade_max_depth > 1``)
        re-runs the staged walk from scratch."""
        B = len(reqs)
        depth = np.zeros(B, np.int64)
        conf = np.ones(B, np.float64)
        final = np.array(choice, np.int64, copy=True)
        confm = confidence_scores(sigma)
        top = len(self._esc_order) - 1
        scores = None
        for i, r in enumerate(reqs):
            thr = r.min_confidence
            if thr <= 0.0:
                continue
            c0 = int(choice[i])
            if confm[i, c0] >= thr or self._ladder_pos[c0] >= top:
                conf[i] = confm[i, c0]
                continue
            e1 = int(esc[i])
            if (confm[i, e1] < thr and self._ladder_pos[e1] < top
                    and self.cascade_max_depth > 1):
                if scores is None:
                    scores = (pred
                              + lambda_matrix(reqs, self._cnames)
                              @ self._cmat)
                final[i], depth[i] = cascade_choice(
                    c0, confm[i], thr, self._esc_order,
                    self.cascade_max_depth, scores[i])
                conf[i] = confm[i, final[i]]
            else:
                final[i], depth[i], conf[i] = e1, 1, confm[i, e1]
        return final, depth, conf

    # --------------------------------------------------- expert executor

    @staticmethod
    def _expert_forward(model, toks, targets, mask):
        """Per-example predictions, masked NLL and masked accuracy.
        Padded rows carry an all-zero mask, so their loss and accuracy
        reduce to 0 under the max(denominator, 1) guard."""
        logits = forward(model, {"tokens": toks}, mode="train").float()
        preds = logits.argmax(-1)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets.long()[..., None])[..., 0]
        m = mask.float()
        denom = m.sum(-1).clamp_min(1.0)
        ex_loss = ((logz - gold) * m).sum(-1) / denom
        ex_acc = ((preds == targets).float() * m).sum(-1) / denom
        return preds, ex_loss, ex_acc

    @torch.inference_mode()
    def _run_expert(self, e, reqs: list[Request]):
        """Execute one padded per-expert micro-batch; returns per-example
        (preds, loss, acc) arrays trimmed back to len(reqs)."""
        n = len(reqs)
        Bp = self._bucket(n)
        S = len(reqs[0].tokens)
        toks = np.zeros((Bp, S), reqs[0].tokens.dtype)
        targets = np.zeros((Bp, S), np.int32)
        mask = np.zeros((Bp, S), np.int32)
        for j, r in enumerate(reqs):
            toks[j] = r.tokens
            if r.targets is not None:
                targets[j] = r.targets
            if r.mask is not None:
                mask[j] = r.mask
        preds, ex_loss, ex_acc = self._expert_forward(
            e.params, self._to_device(toks), self._to_device(targets),
            self._to_device(mask))
        self.stats.bucket_hits[Bp] += 1
        self.stats.padded_rows += Bp - n
        return (preds.cpu().numpy()[:n], ex_loss.cpu().numpy()[:n],
                ex_acc.cpu().numpy()[:n])

    def _route_admitted(self, reqs: list[Request]):
        """Route -> Cascade -> Fallback on one admission batch:
        ``(pred, choice, cached, depth, confidence, fallback_depth)``."""
        ctx = self.pipeline.admit(reqs)
        return (ctx.pred, ctx.choice, ctx.cached, ctx.depth,
                ctx.confidence, ctx.fallback_depth)

    def _execute(self, expert_idx: int, entries: list[LaneEntry],
                 reason: str) -> list[Result]:
        """Execute -> Feedback on one per-expert micro-batch."""
        return self.pipeline.flush(expert_idx, entries, reason)

    def _flush_or_fail(self, sched: ExpertScheduler, expert_idx: int,
                       entries: list[LaneEntry], reason: str,
                       ) -> list[Result]:
        """Execute one scheduled flush, honouring the scheduler's armed
        failure injections and feeding the health tracker.  A failed
        flush never loses a request: its entries are re-routed, or
        answered with terminal failed Results (``_failed_flush``)."""
        if sched.take_failure(expert_idx):
            return self._failed_flush(sched, expert_idx, entries)
        t0 = self._now()
        out = self._execute(expert_idx, entries, reason)
        if self.health is not None:
            self.health.observe_flush(expert_idx, self._now() - t0,
                                      ok=True)
        return out

    def _unrecord_result(self, res: Result) -> None:
        """Reverse the per-request ``EngineStats`` accounting of a Result
        whose speculative execution was discarded (the verdict escalated
        after the provisional entry flushed).  Flush counts, buckets,
        padded rows, expert time and replay feedback stay: that compute
        really happened (``spec_wasted_tokens`` records it)."""
        st = self.stats
        if res.failed:
            st.failed -= 1
            return
        st.served -= 1
        st.per_expert[res.expert] -= 1
        if st.per_expert[res.expert] == 0:
            del st.per_expert[res.expert]
        st.total_flops -= res.flops_proxy
        try:
            st.latencies.remove(res.latency_s)
        except ValueError:
            pass
        st.cascade_depth_hist[res.cascade_depth] -= 1
        if st.cascade_depth_hist[res.cascade_depth] == 0:
            del st.cascade_depth_hist[res.cascade_depth]
        try:
            st.tier_latencies[res.cascade_depth].remove(res.latency_s)
        except (KeyError, ValueError):
            pass
        if res.cascade_depth > 0:
            st.escalations -= 1

    def _failed_flush(self, sched: ExpertScheduler, expert_idx: int,
                      entries: list[LaneEntry]) -> list[Result]:
        """One lane flush failed: record it, then re-route or fail each
        entry.  A re-route re-scores the request's own constrained
        objective with the failed expert masked out and re-enqueues it
        with a larger ``fallback_depth``; past ``fallback_max_depth``
        plus one sweep of the library the request fails terminally
        (``failed=True``, ``flush_reason="failed"``)."""
        e = self.library[expert_idx]
        self.stats.expert_failures[e.name] += 1
        if self.health is not None:
            self.health.record_failure(expert_idx)
        budget = self.fallback_max_depth + len(self.library)
        failed: list[Result] = []
        scores = None
        if self.health is not None and self.fallback_max_depth > 0:
            lam = lambda_matrix([en.req for en in entries], self._cnames)
            scores = np.stack([en.pred for en in entries]) + lam @ self._cmat
            healthy = self.health.healthy_mask().copy()
            avail = self.health.available_mask().copy()
            # the expert that just failed is off the table either way
            healthy[expert_idx] = avail[expert_idx] = False
        now = self._now()
        for j, en in enumerate(entries):
            target = None
            if scores is not None and en.fallback_depth < budget:
                final, fdepth, degraded = fallback_choice(
                    scores[j], healthy, avail, expert_idx,
                    self._esc_order, self.fallback_max_depth)
                if final != expert_idx:
                    target = (final, fdepth, degraded)
            if target is None:
                r = en.req
                self.stats.failed += 1
                failed.append(Result(
                    uid=r.uid, expert=e.name, pred_losses=en.pred,
                    predictions=np.zeros(0, np.int64), loss=None,
                    accuracy=None, flops_proxy=0.0,
                    latency_s=(max(now - r.arrival, 0.0)
                               if r.arrival is not None else 0.0),
                    cached=en.cached, flush_reason="failed",
                    cascade_depth=en.depth, confidence=en.confidence,
                    fallback_depth=en.fallback_depth, failed=True))
                continue
            final, fdepth, degraded = target
            self.stats.reroutes += 1
            if degraded:
                self.stats.degraded += 1
            sched.push(final, en.req, en.pred, en.cached, en.depth,
                       en.confidence, en.fallback_depth + fdepth)
        return failed

    # -------------------------------------------------------- disciplines

    def run(self) -> list[Result]:
        """FIFO drain: route the queue in admission-batch slices and
        launch every per-expert group immediately, however ragged.
        Returns one Result per request.  The baseline ``serve()`` is
        measured against."""
        results: list[Result] = []
        while self.queue:
            batch, self.queue = (self.queue[:self.max_batch],
                                 self.queue[self.max_batch:])
            (pred, choice, cached, depth, conf,
             fdepth) = self._route_admitted(batch)
            by_expert: dict[int, list[int]] = defaultdict(list)
            for i, c in enumerate(choice):
                by_expert[int(c)].append(i)
            for mi, idxs in sorted(by_expert.items()):
                entries = [LaneEntry(batch[i], pred[i], i, bool(cached[i]),
                                     int(depth[i]), float(conf[i]),
                                     int(fdepth[i]))
                           for i in idxs]
                results.extend(self._execute(mi, entries, "fifo"))
        return results

    def serve(self, request_iter: Iterable[Request | None],
              ) -> Iterator[Result]:
        """Continuous batching: stream requests in, stream Results out.

        ``request_iter`` yields ``Request``s, or ``None`` as an idle tick
        that lets deadline flushes fire while nothing arrives.  Admitted
        requests are scored in batches of up to ``max_batch`` and pushed
        into per-expert lanes, which flush on a full bucket or on
        deadline; whatever is pending when the iterator ends is drained.
        Requests already ``submit()``ted are admitted first.  A partial
        admission batch is scored once its oldest request has aged
        ``max_wait_s / 2``, so bursts still share router passes.

        With ``speculate=True`` (a cascade enabled, no health tracker)
        every request is laned on its router choice at once and the
        cascade verdict lands after the tick's flushes: a confirming
        verdict promotes the provisional entry in place, an escalating
        one cancels it (or discards its already-executed Result and
        reverts its accounting) and re-lanes the request.  Exactly one
        Result per request either way.
        """
        sched = ExpertScheduler(len(self.library), self.lane_target,
                                self.max_wait_s)
        self.scheduler = sched
        admitted: list[Request] = []
        # deferring Cascade is sound only while Fallback is a no-op
        spec_on = (self.speculate and self.cascade_max_depth > 0
                   and self.health is None)
        # admission contexts whose verdict is deferred, the uids whose
        # lane entries are provisional (-> first pick), and Results of
        # provisional entries that flushed before their verdict
        inflight: list[tuple[RouteContext, list[int]]] = []
        pending: dict = {}
        held: dict = {}

        def _push_ctx(ctx, specs=frozenset()):
            for i, r in enumerate(ctx.reqs):
                sched.push(int(ctx.choice[i]), r, ctx.pred[i],
                           bool(ctx.cached[i]), int(ctx.depth[i]),
                           float(ctx.confidence[i]),
                           int(ctx.fallback_depth[i]), spec=i in specs)

        def _admit():
            reqs = list(admitted)
            admitted.clear()
            if spec_on:
                ctx = self.pipeline.route(RouteContext(reqs))
                spec_rows = [i for i in ctx.miss_idx
                             if reqs[i].min_confidence > 0.0]
                if spec_rows:
                    for i in spec_rows:
                        pending[reqs[i].uid] = int(ctx.choice[i])
                        self.stats.spec_launched += 1
                    _push_ctx(ctx, frozenset(spec_rows))
                    inflight.append((ctx, spec_rows))
                else:
                    self.pipeline.fallback(self.pipeline.cascade(ctx))
                    _push_ctx(ctx)
            else:
                _push_ctx(self.pipeline.admit(reqs))
            if self.health is not None:
                # every expert's pending depth, zeros included so idle
                # lanes decay
                for mi, d in enumerate(sched.depths()):
                    self.health.observe_lane_depth(mi, d)

        def _resolve():
            # land every deferred verdict and reconcile each provisional
            # lane entry: exactly one Result per request
            while inflight:
                ctx, spec_rows = inflight.pop(0)
                self.pipeline.fallback(self.pipeline.cascade(ctx))
                for i in spec_rows:
                    r = ctx.reqs[i]
                    first = pending.pop(r.uid)
                    final = int(ctx.choice[i])
                    d = int(ctx.depth[i])
                    cf = float(ctx.confidence[i])
                    if d == 0:
                        # hit: the provisional entry (or its flushed
                        # Result) becomes authoritative
                        self.stats.spec_hits += 1
                        en = sched.find_entry(first, r.uid)
                        if en is not None:
                            en.spec = False
                            en.confidence = cf
                        else:
                            res = held.pop(r.uid)
                            res.confidence = cf
                            yield res
                        continue
                    en = sched.remove_entry(first, r.uid)
                    if en is not None:
                        # still queued: cancel and re-lane, no waste
                        self.stats.spec_cancelled += 1
                        sched.push(final, r, en.pred, en.cached, d, cf,
                                   en.fallback_depth)
                    else:
                        # already executed: count the waste, revert its
                        # accounting, re-lane on the verdict's expert
                        self.stats.spec_wasted += 1
                        self.stats.spec_wasted_tokens += len(r.tokens)
                        self._unrecord_result(held.pop(r.uid))
                        sched.push(final, r, ctx.pred[i],
                                   bool(ctx.cached[i]), d, cf,
                                   int(ctx.fallback_depth[i]))

        if self.queue:
            queued, self.queue = self.queue, []
            request_iter = itertools.chain(queued, request_iter)

        for item in request_iter:
            if item is not None:
                if item.arrival is None:
                    item.arrival = self._now()
                admitted.append(item)
            if admitted and (len(admitted) >= self.max_batch
                             or (self._now() - admitted[0].arrival
                                 >= 0.5 * self.max_wait_s)):
                _admit()
            for mi, entries, reason in sched.pop_ready(self._now()):
                for res in self._flush_or_fail(sched, mi, entries,
                                               reason):
                    if res.uid in pending:
                        held[res.uid] = res
                    else:
                        yield res
            if inflight:
                yield from _resolve()
        if admitted:
            _admit()
        if inflight:
            yield from _resolve()
        # a drain flush may re-route entries into other lanes (a failure
        # injected during shutdown), so drain until quiescent
        while sched.pending:
            for mi, entries, reason in sched.drain():
                yield from self._flush_or_fail(sched, mi, entries,
                                               reason)
        assert not inflight and not pending and not held, (
            "speculation left unresolved verdicts or held Results")
        for mi, peak in sched.peaks().items():
            name = self.library[mi].name
            self.stats.lane_peaks[name] = max(
                self.stats.lane_peaks.get(name, 0), peak)
        for mi, peak in sched.esc_peaks().items():
            name = self.library[mi].name + "@esc"
            self.stats.lane_peaks[name] = max(
                self.stats.lane_peaks.get(name, 0), peak)
