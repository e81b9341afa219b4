"""The Tryage serving engine on PyTorch: the ``run()`` path.

A port of ``repro.serving.engine.TryageEngine``'s FIFO drain over the
staged pipeline (``serving.pipeline``): admission batches of
``max_batch`` requests are routed (decision cache, then the router
encoder and the fused decision kernel), cascaded, and each per-expert
group is executed immediately as one padded micro-batch.

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

Not ported yet: ``serve()`` and the continuous-batching scheduler,
speculation, health and fallback, the T2/T3 cache tiers, mesh placement
and online adaptation.  Their knobs are absent from the constructor.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.library import ModelLibrary
from repro_torch.core.objective import (Constraint, cascade_choice,
                                        confidence_scores, constraint_matrix,
                                        escalation_order)
from repro_torch.core.router import (RouterConfig, VersionedParams,
                                     predict_uncertainty, router_embed)
from repro_torch.device import module_device, resolve_device
from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops
from repro_torch.models.model import forward
from repro_torch.serving.cache import DecisionCache
from repro_torch.serving.feedback import ReplayBuffer
from repro_torch.serving.pipeline import ServingPipeline
from repro_torch.serving.requests import Request, Result, lambda_matrix
from repro_torch.serving.scheduler import LaneEntry


def bucket_size(n: int) -> int:
    """Smallest power of two >= n — the padded micro-batch shape."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


@dataclasses.dataclass
class EngineStats:
    """The telemetry ``run()`` fills (a subset of the JAX engine's)."""

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
    flushes: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    latencies: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=65536))
    cache_hits: int = 0
    cache_misses: int = 0
    cache_key_dropped_lambda: int = 0
    escalations: int = 0
    cascade_depth_hist: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    tier_latencies: dict = dataclasses.field(
        default_factory=lambda: defaultdict(
            lambda: deque(maxlen=65536)))
    # launch geometry of each decision kernel per padded batch size:
    # {kernel: {Bp: plan}}
    router_tiles: dict = dataclasses.field(default_factory=dict)
    feedback_events: int = 0
    feedback_dropped: int = 0
    replay_len: int = 0
    replay_cap: int = 0


class TryageEngine:
    """Staged serving pipeline (Route -> Cascade -> Execute -> Feedback)
    over a model library, draining its queue with ``run()``.

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
    - ``replay_cap``: feedback replay-buffer capacity (0 disables it).
    - ``now_fn``: engine clock (injectable for deterministic tests).
    """

    def __init__(self, library: ModelLibrary, router: nn.Module,
                 rc: RouterConfig, constraints: Sequence[Constraint] = (),
                 max_batch: int = 16, buckets: bool = True,
                 decision_cache: bool = True, cache_capacity: int = 4096,
                 cascade_max_depth: int = 2, fused_cascade: bool = False,
                 replay_cap: int = 4096,
                 now_fn: Callable[[], float] = time.monotonic,
                 device=None):
        if len(library) != rc.n_models:
            raise ValueError(f"library has {len(library)} experts, router "
                             f"scores {rc.n_models}")
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
        self.cache = DecisionCache(cache_capacity) if decision_cache else None
        self.cascade_max_depth = cascade_max_depth
        self.fused_cascade = fused_cascade
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

    # -------------------------------------------------------- discipline

    def run(self) -> list[Result]:
        """FIFO drain: route the queue in admission-batch slices and
        launch every per-expert group immediately, however ragged.
        Returns one Result per request."""
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
