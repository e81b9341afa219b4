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

Decision cache: the exact LRU (T1) alone, or with ``cache_kv`` /
``cache_dir`` (T2, a persistent ``serving.kvstore`` store whose keys and
verdicts are byte-identical to the JAX engine's, so one store serves
both) and ``cache_semantic_eps`` (T3, the nearest cached router
embedding within eps, revalidated against the live router version) the
three-tier ``DecisionCacheStack``.  With T3 on, the exact misses of a
batch are embedded once on the card (``_embed_batch``) for the probe,
and those still missing are scored from those embeddings by the
``router_score`` kernel with zero constraints, then a host f64
constraint add and argmin (``_score_from_emb``), as the JAX engine does.

Requests keep their tokens as host numpy int32 arrays (the decision
cache hashes those bytes, identically to the JAX engine); tensors move
to the engine's device only inside the engine.  Expert micro-batches are
padded to power-of-two buckets (``buckets=True``).

Online adaptation: every ``adapt_every`` feedback samples the Feedback
stage replays a batch from the replay buffer through
``core.training.make_router_update_step`` on shadow weights (outside
``inference_mode``, with grad on), and the new router is published with
``VersionedParams.swap``: the version in every decision-cache key moves
on, and the in-memory tiers (T1, T3) are cleared; T2 keeps its records,
which only a replica at their version can read.

Sanitizer (``REPRO_SANITIZE``, ``kernels.sanitize``): the routing and
expert paths own sanitization, as the JAX engine's jit'd paths do, so
the kernel wrappers' checks skip inside them; ``_sanitize_batch`` checks
each scored batch instead (token ids on the host, before the encoder
sees them, then the predictions and the choice).

Mesh placement (``mesh=``, a ``launch.mesh.Mesh`` with axes ``("data",
"model")``): experts are placed on ``model``-axis slices
(``serving.placement``: size-balanced, the ``replicate_hot`` largest
replicated on every slice), and each lane flush runs on the least-busy
device stream among its expert's replicas (``StreamClock``), blocking on
its results as the meshless flush does; the stream clock models the
overlap a multi-device runtime would give.  With ``data > 1`` a decision
batch is padded to a multiple of ``data`` and split into ``data`` row
blocks, each decided by the encoder and the ``router_score`` kernel on
its row's first device with that device's router replica, and gathered
in row order; the fused cascade then stays off, as in the JAX engine.
The encoder passes of T3 and the staged sigma, and the fused cascade,
run on the engine's ``device``, which must be the mesh's first.  A
replica on the device that already holds the module is the module
itself, so a ``(1, 1)`` mesh computes on exactly the meshless engine's
tensors, and no mesh telemetry enters ``EngineStats``
(``mesh_summary()`` holds it): the ``(1, 1)`` engine is bit for bit the
meshless one.
"""

from __future__ import annotations

import copy
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
from repro_torch.core.training import (make_router_update_step,
                                       router_prediction_error)
from repro_torch.device import module_device, resolve_device
from repro_torch.kernels import sanitize
from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops
from repro_torch.models.model import forward
from repro_torch.serving.cache import DecisionCache, DecisionCacheStack
from repro_torch.serving.feedback import ReplayBuffer
from repro_torch.serving.health import ExpertHealth
from repro_torch.serving.kvstore import DiskKVStore
from repro_torch.serving.pipeline import RouteContext, ServingPipeline
from repro_torch.serving.placement import (PlacementMap, StreamClock,
                                           plan_placement)
from repro_torch.serving.requests import Request, Result, lambda_matrix
from repro_torch.serving.scheduler import ExpertScheduler, LaneEntry
from repro_torch.serving.semcache import SemanticCache


def bucket_size(n: int) -> int:
    """Smallest power of two >= n — the padded micro-batch shape."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


@dataclasses.dataclass
class EngineStats:
    """The JAX engine's telemetry, field for field, so that
    ``serving.metrics.render`` reads the same series from both.
    ``cache_tier_hits`` counts every cache hit under its tier (``t1``
    whenever the cache is on, ``t2`` / ``t3`` with those tiers);
    ``cache_revalidations`` counts T3 candidates found within eps and
    ``cache_revalidation_rejects`` those whose router version was
    stale.  ``router_tiles`` holds the port's own launch plans (the
    CUDA kernels' cluster geometry), keyed by kernel name."""

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
    # online adaptation: router updates applied (and the resulting
    # router version), feedback samples published, replay occupancy,
    # time spent in update steps, and the mean |L-hat[chosen] -
    # L_observed| on the last replayed batch before and after its update
    adapt_updates: int = 0
    router_version: int = 0
    feedback_events: int = 0
    feedback_dropped: int = 0
    replay_len: int = 0
    replay_cap: int = 0
    adapt_time_s: float = 0.0
    adapt_pre_err: float = 0.0
    adapt_post_err: float = 0.0
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
                          "tiers": {k: int(v) for k, v in
                                    sorted(self.cache_tier_hits.items())},
                          "revalidations": self.cache_revalidations,
                          "revalidation_rejects":
                              self.cache_revalidation_rejects,
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
                "adaptation": {
                    "updates": self.adapt_updates,
                    "router_version": self.router_version,
                    "feedback_events": self.feedback_events,
                    "feedback_dropped": self.feedback_dropped,
                    "replay": {"len": self.replay_len,
                               "cap": self.replay_cap},
                    "pre_err": round(self.adapt_pre_err, 6),
                    "post_err": round(self.adapt_post_err, 6),
                    "time_s": round(self.adapt_time_s, 3)},
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
      verdicts (T1).
    - ``cache_kv`` / ``cache_dir``: the persistent tier (T2): inject a
      ``serving.kvstore`` store (a ``MemoryKVStore`` shared by replicas,
      or an adapter to a real Valkey), or name a directory for the
      crash-safe ``DiskKVStore``.  The same directory and router version
      give a warm cache after a restart.
    - ``cache_semantic_eps`` / ``cache_semantic_cap``: the semantic tier
      (T3) over router embeddings; ``eps > 0`` turns it on (calibrate
      with ``serving.semcache.calibrate_eps``).  Without T2 and T3 the
      cache is the plain ``DecisionCache``.
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
    - ``adapt_every``: feedback samples between router updates; 0 (the
      default) freezes the router.  ``adapt_lr`` / ``adapt_ema`` /
      ``adapt_batch`` / ``adapt_trainable``: the update recipe
      (``core.training.make_router_update_step``; ``"head"`` adapts the
      loss head only, ``"all"`` also the encoder); ``adapt_seed`` seeds
      the replay sampling.
    - ``replay_cap``: feedback replay-buffer capacity (0 disables it).
    - ``mesh``: a ``launch.mesh.Mesh`` with axes ``("data", "model")``
      whose first device is ``device`` (None: the single-device
      engine).  ``placement``: the expert -> slice ``PlacementMap``
      (default: ``plan_placement`` over the experts' parameter counts);
      ``replicate_hot``: with the default placement, replicate the K
      largest experts on every slice.
    - ``now_fn``: engine clock (injectable for deterministic tests).
    """

    def __init__(self, library: ModelLibrary, router: nn.Module,
                 rc: RouterConfig, constraints: Sequence[Constraint] = (),
                 max_batch: int = 16, buckets: bool = True,
                 decision_cache: bool = True, cache_capacity: int = 4096,
                 cache_kv=None, cache_dir: str | None = None,
                 cache_semantic_eps: float = 0.0,
                 cache_semantic_cap: int = 65536,
                 cascade_max_depth: int = 2, fused_cascade: bool = False,
                 lane_target: int | None = None, max_wait_s: float = 0.05,
                 speculate: bool = False,
                 health: ExpertHealth | None = None,
                 fallback_max_depth: int = 2, adapt_every: int = 0,
                 adapt_lr: float = 1e-2, adapt_ema: float = 0.0,
                 adapt_batch: int = 32, adapt_trainable: str = "head",
                 replay_cap: int = 4096, adapt_seed: int = 0,
                 mesh=None, placement: PlacementMap | None = None,
                 replicate_hot: int = 0,
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
        # exact-only traffic gets the plain LRU; T2 or T3 builds the stack
        self.cache = None
        if decision_cache:
            kv = cache_kv
            if kv is None and cache_dir is not None:
                kv = DiskKVStore(cache_dir)
            sem = (SemanticCache(cache_semantic_eps, cache_semantic_cap)
                   if cache_semantic_eps > 0.0 else None)
            if kv is not None or sem is not None:
                self.cache = DecisionCacheStack(cache_capacity, kv=kv,
                                                semantic=sem)
            else:
                self.cache = DecisionCache(cache_capacity)
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
        if adapt_every < 0 or adapt_batch < 1:
            raise ValueError("adapt_every must be >= 0 and "
                             "adapt_batch >= 1")
        if adapt_every > 0 and replay_cap <= 0:
            raise ValueError("adapt_every > 0 needs a replay buffer "
                             "(replay_cap >= 1)")
        self.adapt_every = adapt_every
        self.adapt_batch = adapt_batch
        self.replay = ReplayBuffer(replay_cap) if replay_cap > 0 else None
        self._adapt_rng = np.random.default_rng(adapt_seed)
        self._fb_at_last_update = 0
        self._update_step = (make_router_update_step(
            rc, lr=adapt_lr, ema=adapt_ema, trainable=adapt_trainable)
            if adapt_every > 0 else None)
        self.pipeline = ServingPipeline(self)
        self._cnames = [c.name for c in self.constraints]
        self._cmat = constraint_matrix(self.constraints, rc.n_models)
        self._cmat_dev = torch.from_numpy(self._cmat).to(self.device)
        self._ladder_dev = torch.from_numpy(
            self._ladder_pos.astype(np.int32)).to(self.device)
        self._expert_idx = {e.name: i for i, e in enumerate(library.experts)}

        # ------------------------------------------------ mesh wiring
        # A (data, model) mesh makes the pipeline multi-device: the
        # routing stage splits decision batches over the "data" axis, and
        # the Execute stage places each expert on a "model"-axis slice
        # (serving.placement) so lane flushes land in per-device streams.
        # mesh=None (the default) is the single-device engine: none of
        # the fields below are consulted.
        self.mesh = mesh
        self.placement: PlacementMap | None = None
        self.streams: StreamClock | None = None
        self._data_ext = 1
        self._mesh_rp_cache: tuple[int, list] | None = None
        if mesh is not None:
            missing = {"data", "model"} - set(mesh.axis_names)
            if missing:
                raise ValueError(f"serving mesh needs axes "
                                 f"('data', 'model'); missing {missing}")
            self._data_ext = int(mesh.shape["data"])
            model_ext = int(mesh.shape["model"])
            if placement is None:
                placement = plan_placement(
                    [e.n_params for e in library.experts], model_ext,
                    replicate_hot=replicate_hot)
            if placement.n_slices != model_ext:
                raise ValueError(f"placement has {placement.n_slices} "
                                 f"slices but the mesh's model axis is "
                                 f"{model_ext}")
            if placement.n_experts != len(library):
                raise ValueError("placement sized for a different library")
            # device grid (data, model): slice k owns column k; stream
            # index == flat device index r * model_ext + k
            grid = mesh.devices.reshape(self._data_ext, model_ext)
            if grid[0, 0] != self.device:
                raise ValueError(
                    f"the mesh's first device is {grid[0, 0]}, the engine "
                    f"runs on {self.device}: the encoder's unsharded "
                    f"passes run on the engine's device, which must lead "
                    f"the mesh")
            self.placement = placement
            self._devices = list(grid.reshape(-1))
            self._data_devices = list(grid[:, 0])
            self._cmat_on = {dev: self._cmat_dev.to(dev)
                             for dev in self._data_devices}
            self.streams = StreamClock(len(self._devices))
            self._expert_streams = {
                i: [r * model_ext + k
                    for k in placement.slices_for(i)
                    for r in range(self._data_ext)]
                for i in range(len(library))}
            # per-(expert, stream) replicas, filled on first dispatch so
            # unused replicas cost nothing
            self._expert_params_on: dict[tuple[int, int], nn.Module] = {}

    @staticmethod
    def _replica(module: nn.Module, dev: torch.device) -> nn.Module:
        """``module`` on ``dev``: the module itself where it already
        lives there, else a copy (made outside ``inference_mode``, so its
        parameters stay ordinary tensors)."""
        if module_device(module) == dev:
            return module
        with torch.inference_mode(False):
            return copy.deepcopy(module).to(dev)

    def _mesh_router_params(self) -> list[nn.Module]:
        """One router replica per ``data`` device (``devices[r, 0]``),
        rebuilt only when adaptation swaps the version (one copy per
        snapshot, not per batch)."""
        if (self._mesh_rp_cache is None
                or self._mesh_rp_cache[0] != self.router_version):
            live = self.router_params
            self._mesh_rp_cache = (self.router_version,
                                   [self._replica(live, dev)
                                    for dev in self._data_devices])
        return self._mesh_rp_cache[1]

    def _expert_replica(self, ei: int, slot: int) -> nn.Module:
        """Expert ``ei``'s replica on stream ``slot``'s device."""
        key = (ei, slot)
        model = self._expert_params_on.get(key)
        if model is None:
            model = self._replica(self.library[ei].params,
                                  self._devices[slot])
            self._expert_params_on[key] = model
        return model

    def mesh_summary(self) -> dict | None:
        """Placement + per-device stream telemetry (None without a
        mesh).  Deliberately *not* part of ``EngineStats`` — the
        1x1-mesh engine must stay bit-for-bit identical to the meshless
        engine, EngineStats included."""
        if self.mesh is None:
            return None
        return {
            "mesh": {k: int(v) for k, v in self.mesh.shape.items()},
            "placement": self.placement.summary(self.library.names),
            "streams": self.streams.summary(),
        }

    @torch.inference_mode()
    @sanitize.owns
    def warm_mesh(self, seq_len: int,
                  bucket_sizes: Sequence[int] | None = None) -> int:
        """Place every expert replica and run every (expert, replica
        stream, bucket size) variant once, so that no flush of measured
        traffic pays a replica's first copy or a first launch on its
        device.  Returns the number of variants run; 0 without a mesh.
        Streams are not charged: warming is not traffic."""
        if self.placement is None:
            return 0
        if bucket_sizes is None:
            bucket_sizes = [b for b in (1, 2, 4, 8, 16, 32, 64, 128)
                            if b <= self.lane_target] or [self.lane_target]
        compiled = 0
        for ei, streams in self._expert_streams.items():
            for slot in streams:
                model = self._expert_replica(ei, slot)
                for b in bucket_sizes:
                    zi = torch.zeros((b, seq_len), dtype=torch.int32,
                                     device=self._devices[slot])
                    preds, _, _ = self._expert_forward(model, zi, zi, zi)
                    preds.cpu()                   # block until it ran
                    compiled += 1
        return compiled

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

    def _to_device(self, a: np.ndarray, device=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device if device is None else device)

    def _padded(self, reqs: list[Request], lam: bool = True,
                multiple: int = 1):
        """Tokens (and lambdas) of ``reqs`` padded with zero rows to the
        bucket size, then to a multiple of ``multiple``, on the
        device."""
        B = len(reqs)
        Bp = self._bucket(B)
        Bp += -Bp % multiple
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
    @sanitize.owns
    def _score_batch(self, reqs: list[Request]) -> tuple[np.ndarray,
                                                         np.ndarray]:
        """Score one batch with the router (no cache): the predicted
        per-expert losses (B, M) f32 and the chosen expert (B,) under
        each request's lambda-weighted constraints, from one
        ``router_score`` launch after the encoder (one per ``data`` block
        on a mesh with ``data > 1``: ``_decide_sharded``)."""
        B = len(reqs)
        t0 = self._now()
        host = self._sanitize_tokens(reqs)
        Bp, (toks, lam) = self._padded(reqs, multiple=self._data_ext)
        router = self.router_params
        if self._data_ext > 1:
            pred, choice = self._decide_sharded(toks, lam)
        else:
            emb = router_embed(router, self.rc, {"tokens": toks})
            pred, choice = rs_ops.router_route(emb, router.head,
                                               self._cmat_dev, lam)
        # keyed by the whole padded batch, as the JAX engine records it
        tiles = self.stats.router_tiles.setdefault("router_score", {})
        if Bp not in tiles:
            tiles[Bp] = rs_ops.decision_plan(Bp, *router.head["w1"].shape)
        if host is not None:
            self._sanitize_batch(host, pred, choice)
        pred = pred.cpu().numpy()[:B]
        choice = choice.cpu().numpy()[:B]
        self.stats.router_time_s += self._now() - t0
        self.stats.router_batches += 1
        return pred, choice

    def _decide_sharded(self, toks: torch.Tensor, lam: torch.Tensor):
        """The data-parallel decision: row block r of the padded batch
        through the encoder and ``router_route`` on ``devices[r, 0]``
        with that device's router replica, one block after another, the
        results gathered in row order on the engine's device."""
        n = toks.shape[0] // self._data_ext
        preds, choices = [], []
        for r, (router, dev) in enumerate(zip(self._mesh_router_params(),
                                              self._data_devices)):
            rows = slice(r * n, (r + 1) * n)
            emb = router_embed(router, self.rc,
                               {"tokens": toks[rows].to(dev)})
            pred, choice = rs_ops.router_route(emb, router.head,
                                               self._cmat_on[dev],
                                               lam[rows].to(dev))
            preds.append(pred.to(self.device))
            choices.append(choice.to(self.device))
        return torch.cat(preds), torch.cat(choices)

    @torch.inference_mode()
    @sanitize.owns
    def _embed_batch(self, reqs: list[Request]) -> np.ndarray:
        """Pooled router embeddings (B, d) f32 for the semantic tier: one
        bucket-padded encoder pass on the device.  Counts as a router
        batch (it is most of one)."""
        B = len(reqs)
        t0 = self._now()
        _, (toks,) = self._padded(reqs, lam=False)
        emb = router_embed(self.router_params, self.rc, {"tokens": toks})
        emb = emb.float().cpu().numpy()[:B]
        self.stats.router_time_s += self._now() - t0
        self.stats.router_batches += 1
        return emb

    @torch.inference_mode()
    @sanitize.owns
    def _score_from_emb(self, reqs: list[Request], emb: np.ndarray,
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Finish scoring from precomputed pooled embeddings (the T3
        probe's encoder pass): the predicted losses from one
        ``router_score`` launch with zero constraints (``router_head``),
        then the lambda-weighted constraint add and the argmin on the
        host in f64, as the JAX engine does (first index wins a tie)."""
        B = len(reqs)
        t0 = self._now()
        Bp = self._bucket(B)
        embp = np.zeros((Bp, emb.shape[1]), np.float32)
        embp[:B] = emb
        router = self.router_params
        pred = rs_ops.router_head(self._to_device(embp), router.head)
        tiles = self.stats.router_tiles.setdefault("router_score", {})
        if Bp not in tiles:
            tiles[Bp] = rs_ops.decision_plan(Bp, *router.head["w1"].shape)
        host = self._sanitize_tokens(reqs)
        if host is not None:
            self._sanitize_batch(host, pred)
        pred = pred.cpu().numpy()[:B]
        scores = pred.copy()
        for c in self.constraints:
            lam = np.array([r.lambdas.get(c.name, 0.0) for r in reqs])
            scores = scores + lam[:, None] * c.values[None, :]
        choice = scores.argmin(axis=1)
        self.stats.router_time_s += self._now() - t0
        return pred, choice

    def _use_fused_cascade(self, reqs: list[Request]) -> bool:
        """Whether this batch takes the one-launch cascade decision: the
        flag is on, the cascade is enabled, the engine is not
        data-sharded (the sharded decision covers ``router_score``
        only, as in the JAX engine), the router has an uncertainty head
        and the batch carries cascade traffic."""
        return (self.fused_cascade and self.cascade_max_depth > 0
                and self._data_ext == 1
                and self.router_params.unc is not None
                and any(r.min_confidence > 0.0 for r in reqs))

    @torch.inference_mode()
    @sanitize.owns
    def _score_cascade_batch(self, reqs: list[Request]) -> tuple[
            np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """One-launch cascade scoring: ``(pred, choice, sigma, esc)``
        from a single ``router_cascade`` launch after the encoder."""
        B = len(reqs)
        t0 = self._now()
        host = self._sanitize_tokens(reqs)
        Bp, (toks, lam) = self._padded(reqs)
        router = self.router_params
        emb = router_embed(router, self.rc, {"tokens": toks})
        pred, sigma, choice, esc = rc_ops.router_route_cascade(
            emb, router.head, router.unc, self._cmat_dev, lam,
            self._ladder_dev)
        tiles = self.stats.router_tiles.setdefault("router_cascade", {})
        if Bp not in tiles:
            tiles[Bp] = rc_ops.decision_plan(Bp, *router.head["w1"].shape)
        if host is not None:
            self._sanitize_batch(host, pred, choice)
        pred, sigma, choice, esc = (t.cpu().numpy()[:B]
                                    for t in (pred, sigma, choice, esc))
        self.stats.router_time_s += self._now() - t0
        self.stats.router_batches += 1
        return pred, choice, sigma, esc

    def _sanitize_tokens(self, reqs: list[Request]):
        """Under ``REPRO_SANITIZE`` the batch's token ids (host numpy),
        range-checked before the encoder sees them (an id past the
        embedding table would fault on the card), else None."""
        if not sanitize.sanitize_enabled():
            return None
        toks = np.stack([r.tokens for r in reqs])
        self._sanitize_batch(toks)
        return toks

    def _sanitize_batch(self, toks, pred=None, choice=None):
        """``REPRO_SANITIZE``: validate one scored batch, as the JAX
        engine does.  Token ids are range-checked on the host (they
        arrive as numpy); the predicted losses (finite) and the choice
        (in [0, M)) with one host sync (``kernels.sanitize``)."""
        vocab = self.rc.vocab_size
        if toks.min() < 0 or toks.max() >= vocab:
            raise ValueError(
                f"router_score: token id out of range [0, {vocab})")
        if pred is None:
            return
        checks = [sanitize.check_finite("router_score", "predicted losses",
                                        pred)]
        if choice is not None:
            checks.append(sanitize.check_in_range(
                "router_score", "expert choice", choice, 0,
                self.rc.n_models))
        sanitize.run_checks(*checks)

    @torch.inference_mode()
    @sanitize.owns
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

    # ------------------------------------------------ online adaptation

    def _maybe_adapt(self):
        """Feedback-cadenced router refresh (called by the Feedback
        stage after each flush).

        One incremental update per ``adapt_every`` published feedback
        samples: a flush that publishes several multiples of
        ``adapt_every`` at once applies every update it owes.  Each
        update replays a fresh batch, steps shadow weights, reads the
        batch prediction error before and after in one sync, and
        publishes the new snapshot with a version-bumping swap; the
        decision cache is cleared on swap (the version in the key
        already makes stale verdicts unreachable; clearing reclaims
        their memory; T2 keeps its records, which only a replica at
        their version can read).  Runs with grad on: the engine's card
        methods run under ``inference_mode``, this one must not."""
        if self.adapt_every <= 0 or self.replay is None:
            return
        while (self.replay.seen - self._fb_at_last_update
               >= self.adapt_every):
            self._fb_at_last_update += self.adapt_every
            t0 = self._now()
            toks, eidx, obs = self.replay.sample(self.adapt_batch,
                                                 self._adapt_rng)
            dt, de, do = (self._to_device(a) for a in (toks, eidx, obs))
            old = self.router_params
            with torch.no_grad():
                pre = router_prediction_error(old, self.rc, dt, de, do)
            new_params, _ = self._update_step(old, dt, de, do)
            with torch.no_grad():
                post = router_prediction_error(new_params, self.rc, dt,
                                               de, do)
            errs = torch.stack([pre, post]).cpu().numpy()  # one sync
            self._router = self._router.swap(new_params)
            if self.cache is not None:
                self.cache.clear()
            self._assert_cache_version()
            self.stats.adapt_updates += 1
            self.stats.router_version = self._router.version
            self.stats.adapt_pre_err = float(errs[0])
            self.stats.adapt_post_err = float(errs[1])
            self.stats.adapt_time_s += self._now() - t0

    def _assert_cache_version(self):
        """Invariant checked after every swap: no entry of a serving
        tier (T1, T3) may carry a router version other than the live
        snapshot's — a stale hit would serve verdicts scored by
        superseded parameters."""
        if self.cache is None:
            return
        stale = self.cache.stale_versions(self._router.version)
        if stale:
            raise RuntimeError(
                f"decision cache holds entries for router version(s) "
                f"{sorted(stale)} but version {self._router.version} is "
                f"live")

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
    @sanitize.owns
    def _run_expert(self, e, reqs: list[Request]):
        """Execute one padded per-expert micro-batch; returns per-example
        (preds, loss, acc) arrays trimmed back to len(reqs).

        With a placement map (mesh serving) the micro-batch is
        dispatched: the least-busy device stream among the expert's
        replica slices runs it with the replica on that device, and its
        blocked wall time and tokens are charged to that stream.  The
        mesh changes *where* a flush runs, never *what* it computes."""
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
        model, dev, slot = e.params, self.device, None
        if self.placement is not None:
            ei = self._expert_idx[e.name]
            slot = self.streams.least_busy(self._expert_streams[ei])
            dev = self._devices[slot]
            model = self._expert_replica(ei, slot)
            t0 = self._now()
        preds, ex_loss, ex_acc = self._expert_forward(
            model, self._to_device(toks, dev), self._to_device(targets, dev),
            self._to_device(mask, dev))
        out = (preds.cpu().numpy()[:n], ex_loss.cpu().numpy()[:n],
               ex_acc.cpu().numpy()[:n])
        if slot is not None:
            # the flush's blocked wall time, charged to its stream
            self.streams.record(slot, self._now() - t0, tokens=n * S)
        self.stats.bucket_hits[Bp] += 1
        self.stats.padded_rows += Bp - n
        return out

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
            if self.streams is not None:
                # a failed flush occupies no stream time, but the
                # per-device view shows where it was headed: the stream
                # _run_expert would have picked
                self.streams.record_failure(self.streams.least_busy(
                    self._expert_streams[expert_idx]))
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
        if self.placement is not None:
            # each expert lane carries its home device slice
            sched.assign_slots(self.placement)
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
