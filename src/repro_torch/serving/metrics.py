"""Prometheus-text-format metrics rendered from ``EngineStats``.

One registry (``METRICS``) is the single source of truth for every
exported series: name, type, labels, and which piece of engine state it
reads.  ``render()`` walks the registry against a live
``EngineStats``/``ExpertHealth`` pair and emits the standard text
exposition format (``# HELP`` / ``# TYPE`` / samples), so any Prometheus
scraper — or ``curl`` — can consume it.  ``docs/METRICS.md`` documents
the same registry and ``tests/test_metrics_docs.py`` asserts the two
never drift.

A port of ``repro.serving.metrics`` with the same registry (series,
order, types, labels, help strings and sources), so that
``docs/METRICS.md`` documents both packages.  Import-light: numpy only;
``render`` duck-types its ``stats`` argument.

Serving: ``start_metrics_server(port, collect)`` runs a background
``ThreadingHTTPServer`` whose ``GET /metrics`` calls ``collect()`` for a
fresh rendering on every scrape; ``render()``'s output can equally be
written to a file at the end of a run.
"""

from __future__ import annotations

import dataclasses
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Sequence

import numpy as np

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# upper bounds (seconds) for the request-latency histogram; chosen to
# straddle max_wait_s deadlines from milliseconds to whole seconds
LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One exported series: its name, Prometheus type, label names, help
    string, and where in the engine state it comes from (documentation
    only — the read itself lives in ``render``)."""

    name: str
    mtype: str                 # counter | gauge | histogram
    labels: tuple
    help: str
    source: str                # "EngineStats.<field>" / "ExpertHealth.<field>"


METRICS: tuple[MetricSpec, ...] = (
    # ------------------------------------------------ traffic counters
    MetricSpec("tryage_requests_served_total", "counter", (),
               "Requests executed and returned as Results.",
               "EngineStats.served"),
    MetricSpec("tryage_requests_by_expert_total", "counter", ("expert",),
               "Requests served, by executing expert.",
               "EngineStats.per_expert"),
    MetricSpec("tryage_requests_admitted_total", "counter", (),
               "Requests admitted through the front end's bounded queue.",
               "EngineStats.admitted"),
    MetricSpec("tryage_requests_shed_total", "counter", (),
               "Requests load-shed at admission (queue full).",
               "EngineStats.shed"),
    MetricSpec("tryage_requests_shed_by_priority_total", "counter",
               ("priority",),
               "Load-shed requests, by Request.priority.",
               "EngineStats.shed_by_priority"),
    MetricSpec("tryage_requests_failed_total", "counter", (),
               "Requests failed outright: expert flush failed and no "
               "fallback was available.",
               "EngineStats.failed"),
    # ---------------------------------------------- routing & cascade
    MetricSpec("tryage_cache_hits_total", "counter", (),
               "Admission rows answered from the decision cache.",
               "EngineStats.cache_hits"),
    MetricSpec("tryage_cache_misses_total", "counter", (),
               "Admission rows freshly scored by the router.",
               "EngineStats.cache_misses"),
    MetricSpec("tryage_cache_tier_hits_total", "counter", ("tier",),
               "Decision-cache hits, by tier (t1 exact LRU, t2 "
               "persistent KV, t3 semantic).",
               "EngineStats.cache_tier_hits"),
    MetricSpec("tryage_cache_revalidations_total", "counter", (),
               "Semantic-tier candidates found within the distance "
               "bound and revalidated against the live router version.",
               "EngineStats.cache_revalidations"),
    MetricSpec("tryage_cache_revalidation_rejects_total", "counter", (),
               "Semantic-tier candidates rejected at revalidation "
               "(stale router version).",
               "EngineStats.cache_revalidation_rejects"),
    MetricSpec("tryage_cache_key_dropped_lambda_total", "counter", (),
               "Request lambda flags with names unknown to the "
               "engine's constraints, dropped from the cache key.",
               "EngineStats.cache_key_dropped_lambda"),
    MetricSpec("tryage_cascade_escalations_total", "counter", (),
               "Requests escalated at least one cascade step.",
               "EngineStats.escalations"),
    MetricSpec("tryage_cascade_depth_total", "counter", ("depth",),
               "Served requests, by cascade escalation depth.",
               "EngineStats.cascade_depth_hist"),
    # --------------------------------------- speculative escalation
    MetricSpec("tryage_speculation_launched_total", "counter", (),
               "Lane entries enqueued before their escalation verdict "
               "resolved (serve() with speculate=True).",
               "EngineStats.spec_launched"),
    MetricSpec("tryage_speculation_hits_total", "counter", (),
               "Speculative entries whose verdict confirmed the "
               "router's first pick.",
               "EngineStats.spec_hits"),
    MetricSpec("tryage_speculation_cancelled_total", "counter", (),
               "Speculative entries pulled back out of their lane "
               "before flushing (verdict escalated; no wasted compute).",
               "EngineStats.spec_cancelled"),
    MetricSpec("tryage_speculation_wasted_total", "counter", (),
               "Speculative executions discarded because the verdict "
               "escalated after the entry already flushed.",
               "EngineStats.spec_wasted"),
    MetricSpec("tryage_speculation_wasted_tokens_total", "counter", (),
               "Tokens executed by discarded speculative flushes.",
               "EngineStats.spec_wasted_tokens"),
    # ------------------------------------------------ health fallback
    MetricSpec("tryage_fallbacks_total", "counter", (),
               "Route-time fallback re-selections (chosen expert "
               "unavailable).",
               "EngineStats.fallbacks"),
    MetricSpec("tryage_fallbacks_by_depth_total", "counter", ("depth",),
               "Route-time fallbacks, by chain-walk depth.",
               "EngineStats.fallback_depth_hist"),
    MetricSpec("tryage_degraded_total", "counter", (),
               "Fallbacks that ended in graceful-degraded mode "
               "(smallest healthy expert).",
               "EngineStats.degraded"),
    MetricSpec("tryage_reroutes_total", "counter", (),
               "Lane entries re-routed after a failed flush.",
               "EngineStats.reroutes"),
    MetricSpec("tryage_expert_failures_total", "counter", ("expert",),
               "Failed flushes, by expert.",
               "EngineStats.expert_failures"),
    # -------------------------------------------- scheduler & compute
    MetricSpec("tryage_flushes_total", "counter", ("reason",),
               "Micro-batch launches, by flush reason (target = full "
               "bucket, incl. at shutdown; deadline; drain = ragged "
               "shutdown tail only; fifo).",
               "EngineStats.flushes"),
    MetricSpec("tryage_padded_rows_total", "counter", (),
               "Wasted rows executed due to bucket padding.",
               "EngineStats.padded_rows"),
    MetricSpec("tryage_flops_proxy_total", "counter", (),
               "Sum of the 2*params*tokens FLOPs proxy over served "
               "requests.",
               "EngineStats.total_flops"),
    MetricSpec("tryage_router_time_seconds_total", "counter", (),
               "Wall time spent in router forward passes.",
               "EngineStats.router_time_s"),
    MetricSpec("tryage_expert_time_seconds_total", "counter", (),
               "Wall time spent in expert forward passes.",
               "EngineStats.expert_time_s"),
    # ------------------------------------------------ online adaptation
    MetricSpec("tryage_adapt_updates_total", "counter", (),
               "Router adaptation updates applied.",
               "EngineStats.adapt_updates"),
    MetricSpec("tryage_feedback_events_total", "counter", (),
               "Observed (prompt, expert, loss) samples published to "
               "replay.",
               "EngineStats.feedback_events"),
    MetricSpec("tryage_router_version", "gauge", (),
               "Version of the router params currently serving.",
               "EngineStats.router_version"),
    MetricSpec("tryage_replay_occupancy", "gauge", (),
               "Replay buffer occupancy (samples held).",
               "EngineStats.replay_len"),
    # ------------------------------------------------------- front end
    MetricSpec("tryage_sessions", "gauge", (),
               "Concurrent client sessions multiplexed by the front end.",
               "EngineStats.sessions"),
    MetricSpec("tryage_admission_queue_peak", "gauge", (),
               "Peak occupancy of the bounded admission queue.",
               "EngineStats.admission_queue_peak"),
    # ----------------------------------------------------- latency
    MetricSpec("tryage_request_latency_seconds", "histogram", (),
               "True enqueue-to-flush latency over the most recent "
               "latency window.",
               "EngineStats.latencies"),
    # ------------------------------------------------- expert health
    MetricSpec("tryage_expert_healthy", "gauge", ("expert",),
               "1 if the expert passes the health checks (no forced "
               "down, failure EWMA below threshold, out of cooldown).",
               "ExpertHealth.healthy"),
    MetricSpec("tryage_expert_available", "gauge", ("expert",),
               "1 if the expert is healthy and not overloaded.",
               "ExpertHealth.available"),
    MetricSpec("tryage_expert_lane_depth_ewma", "gauge", ("expert",),
               "EWMA of the expert's pending lane depth (saturation "
               "signal).",
               "ExpertHealth.depth_ewma"),
    MetricSpec("tryage_expert_flush_latency_ewma_seconds", "gauge",
               ("expert",),
               "EWMA of the expert's flush execution latency.",
               "ExpertHealth.latency_ewma_s"),
    MetricSpec("tryage_expert_failure_ewma", "gauge", ("expert",),
               "EWMA of the expert's flush failure rate.",
               "ExpertHealth.failure_ewma"),
)


def metric_names() -> list[str]:
    """Every exported series name, registry order — the contract that
    ``docs/METRICS.md`` documents and its parity test checks."""
    return [m.name for m in METRICS]


def _esc(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"")


def _fmt(value: float) -> str:
    f = float(value)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Writer:
    def __init__(self):
        self.lines: list[str] = []

    def header(self, m: MetricSpec) -> None:
        self.lines.append(f"# HELP {m.name} {m.help}")
        self.lines.append(f"# TYPE {m.name} {m.mtype}")

    def sample(self, name: str, labels: dict, value: float) -> None:
        lab = ""
        if labels:
            inner = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
            lab = "{" + inner + "}"
        self.lines.append(f"{name}{lab} {_fmt(value)}")


def _spec(name: str) -> MetricSpec:
    for m in METRICS:
        if m.name == name:
            return m
    raise KeyError(name)


def _labelled(w: _Writer, name: str, label: str, mapping: dict) -> None:
    w.header(_spec(name))
    for key in sorted(mapping, key=str):
        w.sample(name, {label: key}, mapping[key])


def _scalar(w: _Writer, name: str, value: float) -> None:
    w.header(_spec(name))
    w.sample(name, {}, value)


def _histogram(w: _Writer, name: str, values: Sequence[float]) -> None:
    w.header(_spec(name))
    vals = np.asarray(list(values), np.float64)
    cum = 0
    for ub in LATENCY_BUCKETS:
        cum = int((vals <= ub).sum()) if vals.size else 0
        w.sample(name + "_bucket", {"le": _fmt(ub)}, cum)
    w.sample(name + "_bucket", {"le": "+Inf"}, int(vals.size))
    w.sample(name + "_sum", {}, float(vals.sum()) if vals.size else 0.0)
    w.sample(name + "_count", {}, int(vals.size))


def render(stats, health=None, expert_names: Sequence[str] | None = None
           ) -> str:
    """Render the full registry against a live ``EngineStats`` (and
    optionally ``ExpertHealth``) as Prometheus text exposition format.

    ``expert_names`` maps health indices to expert names for the
    per-expert health gauges; without it (or without ``health``) those
    series render with no samples, headers only — a scraper sees the
    series exist and empty, not absent."""
    w = _Writer()
    _scalar(w, "tryage_requests_served_total", stats.served)
    _labelled(w, "tryage_requests_by_expert_total", "expert",
              dict(stats.per_expert))
    _scalar(w, "tryage_requests_admitted_total", stats.admitted)
    _scalar(w, "tryage_requests_shed_total", stats.shed)
    _labelled(w, "tryage_requests_shed_by_priority_total", "priority",
              dict(stats.shed_by_priority))
    _scalar(w, "tryage_requests_failed_total", stats.failed)
    _scalar(w, "tryage_cache_hits_total", stats.cache_hits)
    _scalar(w, "tryage_cache_misses_total", stats.cache_misses)
    _labelled(w, "tryage_cache_tier_hits_total", "tier",
              dict(stats.cache_tier_hits))
    _scalar(w, "tryage_cache_revalidations_total",
            stats.cache_revalidations)
    _scalar(w, "tryage_cache_revalidation_rejects_total",
            stats.cache_revalidation_rejects)
    _scalar(w, "tryage_cache_key_dropped_lambda_total",
            stats.cache_key_dropped_lambda)
    _scalar(w, "tryage_cascade_escalations_total", stats.escalations)
    _labelled(w, "tryage_cascade_depth_total", "depth",
              dict(stats.cascade_depth_hist))
    _scalar(w, "tryage_speculation_launched_total", stats.spec_launched)
    _scalar(w, "tryage_speculation_hits_total", stats.spec_hits)
    _scalar(w, "tryage_speculation_cancelled_total",
            stats.spec_cancelled)
    _scalar(w, "tryage_speculation_wasted_total", stats.spec_wasted)
    _scalar(w, "tryage_speculation_wasted_tokens_total",
            stats.spec_wasted_tokens)
    _scalar(w, "tryage_fallbacks_total", stats.fallbacks)
    _labelled(w, "tryage_fallbacks_by_depth_total", "depth",
              dict(stats.fallback_depth_hist))
    _scalar(w, "tryage_degraded_total", stats.degraded)
    _scalar(w, "tryage_reroutes_total", stats.reroutes)
    _labelled(w, "tryage_expert_failures_total", "expert",
              dict(stats.expert_failures))
    _labelled(w, "tryage_flushes_total", "reason", dict(stats.flushes))
    _scalar(w, "tryage_padded_rows_total", stats.padded_rows)
    _scalar(w, "tryage_flops_proxy_total", stats.total_flops)
    _scalar(w, "tryage_router_time_seconds_total", stats.router_time_s)
    _scalar(w, "tryage_expert_time_seconds_total", stats.expert_time_s)
    _scalar(w, "tryage_adapt_updates_total", stats.adapt_updates)
    _scalar(w, "tryage_feedback_events_total", stats.feedback_events)
    _scalar(w, "tryage_router_version", stats.router_version)
    _scalar(w, "tryage_replay_occupancy", stats.replay_len)
    _scalar(w, "tryage_sessions", stats.sessions)
    _scalar(w, "tryage_admission_queue_peak", stats.admission_queue_peak)
    _histogram(w, "tryage_request_latency_seconds", stats.latencies)
    health_series = (
        ("tryage_expert_healthy",
         lambda i: 1.0 if health.healthy(i) else 0.0),
        ("tryage_expert_available",
         lambda i: 1.0 if health.available(i) else 0.0),
        ("tryage_expert_lane_depth_ewma",
         lambda i: health.states[i].depth_ewma),
        ("tryage_expert_flush_latency_ewma_seconds",
         lambda i: health.states[i].latency_ewma_s),
        ("tryage_expert_failure_ewma",
         lambda i: health.states[i].failure_ewma),
    )
    for name, read in health_series:
        w.header(_spec(name))
        if health is not None and expert_names is not None:
            for i, ename in enumerate(expert_names):
                w.sample(name, {"expert": ename}, read(i))
    return "\n".join(w.lines) + "\n"


class MetricsServer:
    """Background HTTP server exposing ``GET /metrics``.

    ``collect`` is called on every scrape and must return the rendered
    exposition text — bind it to a live engine with
    ``lambda: render(engine.stats, engine.health, names)``."""

    def __init__(self, port: int, collect: Callable[[], str],
                 host: str = "127.0.0.1"):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                          # noqa: N802
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = outer.collect().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):                 # silence stderr
                pass

        self.collect = collect
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def start_metrics_server(port: int, collect: Callable[[], str],
                         host: str = "127.0.0.1") -> MetricsServer:
    """Start a daemon-thread metrics endpoint; returns the server (use
    ``.port`` when ``port=0`` picked an ephemeral one)."""
    return MetricsServer(port, collect, host).start()
