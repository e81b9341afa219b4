"""The staged serving pipeline: Route -> Cascade -> Fallback on an
admission batch, Execute -> Feedback on a per-expert micro-batch.

A port of ``repro.serving.pipeline``: Route probes the decision cache
(the T1 LRU, or the stack's T1 -> T2 exact tiers, counting each hit by
tier), then, when the semantic tier is on, embeds the exact misses in
one encoder pass and probes T3 per row; the remaining misses are scored
as one batch (through the fused cascade kernel when the batch carries
cascade traffic and the engine allows it, or from the T3 probe's
embeddings through ``engine._score_from_emb``); Cascade applies the
abstention/escalation rule to the freshly scored rows and memoises the
post-cascade verdict in every tier; Fallback re-routes rows whose
expert the health tracker holds unavailable (a strict no-op without
one); Execute runs the padded expert forward and builds ``Result``s;
Feedback publishes observed losses to the replay buffer.

With the semantic tier on, exact misses are scored from the T3 probe's
embeddings and so never take the fused cascade kernel: their cascade
runs the staged sigma pass, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.objective import fallback_choice
from repro_torch.serving.cache import DecisionCache
from repro_torch.serving.requests import Request, Result, lambda_matrix
from repro_torch.serving.scheduler import LaneEntry

if TYPE_CHECKING:                                      # pragma: no cover
    from repro_torch.serving.engine import TryageEngine


@dataclasses.dataclass
class RouteContext:
    """One admission batch flowing Route -> Cascade.

    ``miss_idx`` lists the rows freshly scored this batch — the only
    rows Cascade touches, because cache hits already carry their
    post-cascade verdict.  ``emb`` maps row -> pooled router embedding,
    filled only when the semantic tier is on (Cascade feeds them back
    into T3).  ``fused`` is ``(rows, sigma, esc)`` when Route scored the
    misses through the fused cascade kernel, else None."""

    reqs: list[Request]
    pred: np.ndarray | None = None          # (B, M) f32 router L-hat
    choice: np.ndarray | None = None        # (B,) i64 expert index
    cached: np.ndarray | None = None        # (B,) bool cache hits
    depth: np.ndarray | None = None         # (B,) i64 cascade depth
    confidence: np.ndarray | None = None    # (B,) f64 final confidence
    fallback_depth: np.ndarray | None = None  # (B,) i64 health fallbacks
    keys: list | None = None
    miss_idx: list[int] = dataclasses.field(default_factory=list)
    emb: dict | None = None
    fused: tuple | None = None


@dataclasses.dataclass
class FlushContext:
    """One per-expert micro-batch flowing Execute -> Feedback."""

    expert_idx: int
    entries: list[LaneEntry]
    reason: str
    results: list[Result] = dataclasses.field(default_factory=list)


class RouteStage:
    """Score an admission batch through the decision cache.

    Hits return their memoised post-cascade verdict and count under
    their tier; misses are scored as one (smaller) batch.  The cache key
    carries the live router version, so verdicts scored by a superseded
    router can never hit."""

    def __init__(self, engine: "TryageEngine"):
        self.eng = engine

    def __call__(self, ctx: RouteContext) -> RouteContext:
        eng = self.eng
        B = len(ctx.reqs)
        ctx.pred = np.zeros((B, eng.rc.n_models), np.float32)
        ctx.choice = np.zeros(B, np.int64)
        ctx.cached = np.zeros(B, bool)
        ctx.depth = np.zeros(B, np.int64)
        ctx.confidence = np.ones(B, np.float64)
        ctx.fallback_depth = np.zeros(B, np.int64)
        if eng.cache is None:
            misses = list(range(B))
        else:
            sink = self._dropped_lambda_sink
            ctx.keys = [DecisionCache.key(r.tokens, r.lambdas, eng._cnames,
                                          r.min_confidence,
                                          eng.router_version,
                                          unknown_sink=sink)
                        for r in ctx.reqs]
            misses = []
            for i, key in enumerate(ctx.keys):
                hit, tier = eng.cache.lookup(key)
                if hit is None:
                    misses.append(i)
                else:
                    (ctx.pred[i], ctx.choice[i], ctx.depth[i],
                     ctx.confidence[i]) = hit
                    ctx.cached[i] = True
                    eng.stats.cache_tier_hits[tier] += 1
            if misses and getattr(eng.cache, "semantic", None) is not None:
                misses = self._semantic_probe(ctx, misses)
            eng.stats.cache_hits += B - len(misses)
            eng.stats.cache_misses += len(misses)
        if misses:
            if ctx.emb is not None:
                # the T3 probe already embedded these rows: finish the
                # score from its embeddings (head kernel + host argmin)
                mpred, mchoice = eng._score_from_emb(
                    [ctx.reqs[i] for i in misses],
                    np.stack([ctx.emb[i] for i in misses]))
            else:
                mpred, mchoice = self._score_rows(ctx, misses)
            ctx.pred[misses] = mpred
            ctx.choice[misses] = mchoice
        ctx.miss_idx = misses
        return ctx

    def _score_rows(self, ctx: RouteContext, rows: list[int]):
        """Score the given rows as one batch: through the fused cascade
        kernel when the engine and the batch qualify (sigma and the
        escalation target ride along on ``ctx.fused``), else through
        ``_score_batch``."""
        eng = self.eng
        reqs = [ctx.reqs[i] for i in rows]
        if eng._use_fused_cascade(reqs):
            pred, choice, sigma, esc = eng._score_cascade_batch(reqs)
            ctx.fused = (list(rows), sigma, esc)
            return pred, choice
        return eng._score_batch(reqs)

    def _dropped_lambda_sink(self, names: list) -> None:
        self.eng.stats.cache_key_dropped_lambda += len(names)

    def _semantic_probe(self, ctx: RouteContext,
                        misses: list[int]) -> list[int]:
        """T3 pass over the exact-miss rows: one batched embedding pass,
        then a nearest-neighbour probe per row.  A hit adopts the cached
        post-cascade verdict (revalidated against the live router
        version, ``semcache.SemanticCache``) and is promoted into the
        exact tiers under the row's own key; the remaining rows keep
        their embeddings in ``ctx.emb`` for scoring and T3 insertion.
        Returns the rows still missing."""
        eng = self.eng
        emb = eng._embed_batch([ctx.reqs[i] for i in misses])
        ctx.emb = {i: emb[j] for j, i in enumerate(misses)}
        still = []
        for j, i in enumerate(misses):
            entry, status = eng.cache.lookup_semantic(
                emb[j], ctx.keys[i], eng.router_version)
            if status != "miss":
                eng.stats.cache_revalidations += 1
            if status == "hit":
                (ctx.pred[i], ctx.choice[i], ctx.depth[i],
                 ctx.confidence[i]) = entry
                ctx.cached[i] = True
                eng.stats.cache_tier_hits["t3"] += 1
                # the next identical retry is a T1 hit, no encoder pass
                eng.cache.put(ctx.keys[i], entry[0], entry[1],
                              int(entry[2]), float(entry[3]))
                continue
            if status == "stale":
                eng.stats.cache_revalidation_rejects += 1
            still.append(i)
        return still


class CascadeStage:
    """Apply the abstention/escalation rule to freshly scored rows and
    memoise the post-cascade verdict (in every tier the cache has)."""

    def __init__(self, engine: "TryageEngine"):
        self.eng = engine

    def __call__(self, ctx: RouteContext) -> RouteContext:
        eng = self.eng
        if not ctx.miss_idx:
            return ctx
        miss_reqs = [ctx.reqs[i] for i in ctx.miss_idx]
        mpred = ctx.pred[ctx.miss_idx]
        if ctx.fused is not None and ctx.fused[0] == ctx.miss_idx:
            _, sigma, esc = ctx.fused
            mchoice, mdepth, mconf = eng._cascade_fused(
                miss_reqs, mpred, ctx.choice[ctx.miss_idx], sigma, esc)
        else:
            mchoice, mdepth, mconf = eng._cascade(
                miss_reqs, mpred, ctx.choice[ctx.miss_idx])
        for j, i in enumerate(ctx.miss_idx):
            ctx.choice[i] = mchoice[j]
            ctx.depth[i] = mdepth[j]
            ctx.confidence[i] = mconf[j]
            if ctx.keys is None:
                continue
            if ctx.emb is not None:
                # semantic tier on: T3 learns this verdict too
                eng.cache.put(ctx.keys[i], mpred[j], mchoice[j],
                              int(mdepth[j]), float(mconf[j]),
                              emb=ctx.emb[i])
            else:
                eng.cache.put(ctx.keys[i], mpred[j], mchoice[j],
                              int(mdepth[j]), float(mconf[j]))
        return ctx


class FallbackStage:
    """Health consult: walk the fallback chain for requests whose chosen
    expert is unhealthy or saturated (``core.objective.fallback_choice``
    over ``engine.health``'s availability mask).

    Runs after Cascade on every row, cache hits included: health is
    time-varying and never memoised, so the cache keeps the pre-fallback
    verdict and this stage re-applies the current health picture.  With
    no health tracker, no fallback budget, or every expert available it
    is a strict no-op."""

    def __init__(self, engine: "TryageEngine"):
        self.eng = engine

    def __call__(self, ctx: RouteContext) -> RouteContext:
        eng = self.eng
        if eng.health is None or eng.fallback_max_depth <= 0:
            return ctx
        avail = eng.health.available_mask()
        if avail.all():
            return ctx
        healthy = eng.health.healthy_mask()
        # the constrained objective Route minimised: L-hat + lambda . C
        scores = ctx.pred + lambda_matrix(ctx.reqs, eng._cnames) @ eng._cmat
        for i in range(len(ctx.reqs)):
            final, fdepth, degraded = fallback_choice(
                scores[i], healthy, avail, int(ctx.choice[i]),
                eng._esc_order, eng.fallback_max_depth)
            if fdepth == 0:
                continue
            ctx.choice[i] = final
            ctx.fallback_depth[i] = fdepth
            eng.stats.fallbacks += 1
            eng.stats.fallback_depth_hist[fdepth] += 1
            if degraded:
                eng.stats.degraded += 1
        return ctx


class ExecuteStage:
    """Launch one padded per-expert micro-batch and materialise Results
    with true enqueue->flush latency and the execution telemetry."""

    def __init__(self, engine: "TryageEngine"):
        self.eng = engine

    def __call__(self, ctx: FlushContext) -> FlushContext:
        eng = self.eng
        e = eng.library[ctx.expert_idx]
        t0 = eng._now()
        preds, ex_loss, ex_acc = eng._run_expert(
            e, [en.req for en in ctx.entries])
        end = eng._now()
        eng.stats.expert_time_s += end - t0
        eng.stats.flushes[ctx.reason] += 1
        for j, en in enumerate(ctx.entries):
            r = en.req
            loss = acc = None
            if (r.targets is not None and r.mask is not None
                    and r.mask.astype(bool).any()):
                loss = float(ex_loss[j])
                acc = float(ex_acc[j])
            flops = 2.0 * e.n_params * len(r.tokens)
            latency = (max(end - r.arrival, 0.0) if r.arrival is not None
                       else end - t0)
            ctx.results.append(Result(
                uid=r.uid, expert=e.name, pred_losses=en.pred,
                predictions=preds[j], loss=loss, accuracy=acc,
                flops_proxy=flops, latency_s=latency, cached=en.cached,
                flush_reason=ctx.reason, cascade_depth=en.depth,
                confidence=en.confidence,
                fallback_depth=en.fallback_depth))
            eng.stats.served += 1
            eng.stats.per_expert[e.name] += 1
            eng.stats.total_flops += flops
            eng.stats.latencies.append(latency)
            eng.stats.cascade_depth_hist[en.depth] += 1
            eng.stats.tier_latencies[en.depth].append(latency)
            if en.depth > 0:
                eng.stats.escalations += 1
        return ctx


class FeedbackStage:
    """Close the loop: publish each observed (prompt, expert, loss)
    sample to the replay buffer and let the adaptation loop refresh the
    router (``engine._maybe_adapt``, a no-op unless the engine was built
    with ``adapt_every > 0``)."""

    def __init__(self, engine: "TryageEngine"):
        self.eng = engine

    def __call__(self, ctx: FlushContext) -> FlushContext:
        eng = self.eng
        if eng.replay is None:
            return ctx
        for en, res in zip(ctx.entries, ctx.results):
            if res.loss is not None:
                eng.replay.add(en.req.tokens, ctx.expert_idx, res.loss)
        eng.stats.feedback_events = eng.replay.seen
        eng.stats.feedback_dropped = eng.replay.dropped
        eng.stats.replay_len = len(eng.replay)
        eng.stats.replay_cap = eng.replay.capacity
        eng._maybe_adapt()
        return ctx


class ServingPipeline:
    """The five stages composed over one engine: ``admit`` runs
    Route -> Cascade -> Fallback, ``flush`` Execute -> Feedback."""

    def __init__(self, engine: "TryageEngine"):
        self.route = RouteStage(engine)
        self.cascade = CascadeStage(engine)
        self.fallback = FallbackStage(engine)
        self.execute = ExecuteStage(engine)
        self.feedback = FeedbackStage(engine)

    def admit(self, reqs: list[Request]) -> RouteContext:
        return self.fallback(self.cascade(self.route(RouteContext(reqs))))

    def flush(self, expert_idx: int, entries: list[LaneEntry],
              reason: str) -> list[Result]:
        ctx = FlushContext(expert_idx, entries, reason)
        return self.feedback(self.execute(ctx)).results
