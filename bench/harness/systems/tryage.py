"""Driver for a served Tryage library (``system: tryage``): the port's
``TryageEngine.serve()`` under a closed loop of ``prompts`` traffic.

Set-up makes the traffic's prompt pool and the weights on the device,
fits the router's head so that it routes by domain (below), builds the
engine through the configuration's file, runs the router and every
expert once at each bucket size a flush can take, then serves the
mix's ``warm_requests`` through the same loop the window uses, which
fills the decision cache as the traffic would.  The window is the next
``seconds`` of that loop.

The router's weights are random, so its decisions would follow one
draw rather than the prompts.  A trained router predicts each expert's
loss on the prompt: lower for larger experts and for the specialists of
the prompt's domain.  So set-up fits the head to such a table
(``loss_table``) on every prompt of the pool (``fit_router_head``);
the engine and the reference then both read the fitted weights, and
every seed routes the same mix of domains and flags to the same
experts.  Each run reports the share of its window's Results each
expert served (``notes``).

The loop is closed and never starves the engine: whenever ``serve()``
asks for a request the stream hands it a new one, as long as fewer
than ``outstanding`` are unanswered, and an idle tick (``None``)
otherwise, so the engine's deadlines fire.  The engine asks once a
scheduling tick, so it holds fewer in flight than the limit when its
ticks are slow.  A request's latency runs from when the stream handed
it over to when its ``Result`` reached the loop; ``req_per_s`` counts
the Results that reached it in the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from costs import flops as costs
from harness import checks
from harness.corpus import DOMAINS
from harness.traffic import Prompts
from harness.weights import derive, make
from reference.precision import Products, no_tf32

BUCKETS_UP_TO = 256


def _keep(uid: int, seed: int, every: int) -> bool:
    return (derive(seed, f"keep:{uid}") % every) == 0


def _order(uid: int, seed: int) -> int:
    return derive(seed, f"pick:{uid}")


def loss_table(cfg: dict, ref) -> np.ndarray:
    """(domains, experts) float64: the loss a trained router predicts for
    each expert on a prompt of each domain of ``DOMAINS``: ``loss_base
    - loss_per_log_param ln(params / 1e6) - loss_per_focus m``, where
    ``m`` is the expert's training weight on the domain (``focus_weight``
    spread over its focus domains, the rest over all; uniform without
    focus)."""
    fit = cfg["router_fit"]
    w, nd = fit["focus_weight"], len(DOMAINS)
    out = np.empty((nd, len(cfg["experts"])))
    for j, e in enumerate(cfg["experts"]):
        focus = e["focus"]
        m = np.array([((1 - w) / nd + (w / len(focus) if d in focus else 0))
                      if focus else 1 / nd for d in DOMAINS])
        out[:, j] = (fit["loss_base"] - fit["loss_per_log_param"]
                     * np.log(ref.n_params(cfg, e) / 1e6)
                     - fit["loss_per_focus"] * m)
    return out


@torch.no_grad()
def fit_router_head(cfg: dict, ref, weights: dict, tokens, domains) -> float:
    """Set the router's head in ``weights`` (in place) so that it predicts
    ``loss_table`` by domain, as a trained router does, on prompts
    ``tokens`` (N, S) on the device of domains ``domains`` (N,).

    Hidden units ``2k`` and ``2k + 1`` read the one-vs-rest discriminant
    of domain ``k`` in the reference's pooled states (within-domain
    covariance shrunk by ``shrink``), scaled so that the domain's mean
    lies at ``+ramp_span`` and the others' at ``-ramp_span``; the second
    is shifted by ``ramp_width``, so the difference of the two is a ramp
    that is 0 off the domain and ``ramp_width`` on it.  ``w2`` and
    ``b2`` are the ridge regression of those units onto the inverse
    softplus of the table; the other hidden units keep their drawn
    ``w1`` and ``b1`` and get zero rows of ``w2``.  Returns the share of
    the prompts whose unflagged pick is the table's pick for their
    domain."""
    no_tf32()
    P = Products("f32")
    fit = cfg["router_fit"]
    e = torch.cat([ref.pooled(weights, cfg, tokens[i:i + checks.ROUTER_ROWS],
                              P) for i in range(0, len(tokens),
                                                checks.ROUTER_ROWS)]).double()
    dom = torch.as_tensor(domains, device=e.device)
    nd = len(DOMAINS)
    mu = torch.stack([e[dom == k].mean(0) for k in range(nd)])
    xc = e - mu[dom]
    sw = xc.T @ xc / len(e)
    sw += fit["shrink"] * sw.diagonal().mean() * torch.eye(
        len(sw), device=e.device, dtype=sw.dtype)
    w1, b1 = weights["router.head.w1"], weights["router.head.b1"]
    for k in range(nd):
        v = torch.linalg.solve(sw, mu[k] - e[dom != k].mean(0))
        on, off = (e[dom == k] @ v).mean(), (e[dom != k] @ v).mean()
        a = 2 * fit["ramp_span"] / (on - off)
        for j, shift in ((2 * k, 0.0), (2 * k + 1, fit["ramp_width"])):
            w1[:, j] = v * a
            b1[j] = -(on + off) / 2 * a - shift
    g = ref.head_hidden(weights, e.float(), P)[:, :2 * nd].double()
    table = loss_table(cfg, ref)
    want = torch.from_numpy(table[domains]).to(e.device)
    z = want + torch.log(-torch.expm1(-want))          # softplus^-1
    x = torch.cat([g, torch.ones_like(g[:, :1])], 1)
    gram = x.T @ x
    ridge = fit["ridge"] * gram.diagonal().mean()
    sol = torch.linalg.solve(
        gram + ridge * torch.eye(len(gram), device=e.device, dtype=gram.dtype),
        x.T @ z)
    weights["router.head.w2"].zero_()
    weights["router.head.w2"][:2 * nd] = sol[:-1]
    weights["router.head.b2"].copy_(sol[-1])
    # softplus is monotone: the pick of the fitted z is the head's
    hit = (x @ sol).argmin(1).cpu().numpy() == table.argmin(1)[domains]
    return float(hit.mean())


class Run:
    def __init__(self, cfg, mix, ref, adapter, seed, device):
        self.cfg, self.mix, self.ref, self.adapter = cfg, mix, ref, adapter
        self.seed = seed
        self.device = torch.device(device)
        self.outputs = {}
        self.attempted = self.failed = 0
        self.phases, self.notes = {}, {}

    # ------------------------------------------------------------ set-up

    def setup(self):
        cfg, ref, dev = self.cfg, self.ref, self.device
        t = time.monotonic()
        self.traffic = Prompts(self.mix, cfg["vocab_size"], self.seed)
        t = self._phase("traffic_pool", t)
        specs = ref.param_specs(cfg)
        router = [s for s in specs if s[0].startswith("router.")]
        experts = [s for s in specs if not s[0].startswith("router.")]
        dtype = getattr(torch, cfg["dtype"])
        self.weights = make(
            router, [(derive(cfg["router_seed"], "router"), 1.0),
                     (derive(self.seed, "router"),
                      cfg["router_seed_perturbation"])], dev, dtype)
        self.weights.update(make(experts, [(derive(self.seed, "experts"),
                                            1.0)], dev, dtype))
        self.notes["router_fit_agreement"] = fit_router_head(
            cfg, ref, self.weights,
            torch.from_numpy(self.traffic.tokens).to(dev),
            self.traffic.domains)
        t = self._phase("weights_and_router_fit", t)
        built = self.adapter.build(cfg, ref, self.weights, dev)
        self.engine = built["engine"]
        t = self._phase("engine", t)
        self._warm_shapes(built)
        t = self._phase("warm_shapes", t)
        self._flops_of = self._request_flops()
        self._start_stream()
        self._warm_stream()
        self._phase("warm_stream", t)

    def _phase(self, name, t0):
        now = time.monotonic()
        self.phases[name] = now - t0
        return now

    @torch.inference_mode()
    def _warm_shapes(self, built):
        from repro_torch.core.router import router_embed
        from repro_torch.kernels.router_score.ops import router_route
        from repro_torch.models.model import forward
        S = self.mix["prompt_len"]
        rc = built["router"].rc
        M = rc.n_models
        ncons = len(self.cfg["constraints"])
        b = 1
        while b <= min(BUCKETS_UP_TO, self.cfg["engine"]["max_batch"]):
            toks = torch.full((b, S), 5, dtype=torch.int32, device=self.device)
            emb = router_embed(built["router"], rc, {"tokens": toks})
            pred, _ = router_route(emb, built["router"].head,
                                   torch.zeros(ncons, M), torch.zeros(b, ncons))
            pred.cpu()
            for e in built["library"].experts:
                forward(e.params, {"tokens": toks}, mode="train").argmax(-1).cpu()
            b *= 2

    def _request_flops(self) -> dict:
        """Model FLOPs of a request's expert forward, by expert name, and
        of its router pass (``None``)."""
        S = self.mix["prompt_len"]

        def shape(m):
            return {"layers": m["num_hidden_layers"], "d": m["hidden_size"],
                    "heads": m["num_attention_heads"],
                    "kv_heads": m["num_attention_heads"],
                    "ff": m["intermediate_size"], "vocab": m["vocab_size"]}

        out = {e["name"]: costs.forward_flops(shape(e), 1, S, causal=False,
                                              logit_positions=S)
               for e in self.cfg["experts"]}
        r = self.cfg["router"]
        out[None] = (costs.forward_flops(shape(r), 1, S, causal=False)
                     + 2 * r["hidden_size"] * r["head_hidden"]
                     + 2 * r["head_hidden"] * r["n_models"])
        return out

    # ------------------------------------------------------------ window

    def _counters(self) -> dict:
        st = self.engine.stats
        return {"served": st.served, "router_time_s": st.router_time_s,
                "router_batches": st.router_batches,
                "expert_time_s": st.expert_time_s,
                "flushes": sum(st.flushes.values()),
                "padded_rows": st.padded_rows,
                "rows_launched": sum(b * n for b, n in st.bucket_hits.items()),
                "cache_hits": st.cache_hits, "cache_misses": st.cache_misses}

    def _start_stream(self):
        """Open the one ``serve()`` stream that set-up and the window
        share; ``self.st`` steers it."""
        from repro_torch.serving import Request
        mix = self.mix
        limit = mix["outstanding"]
        st = self.st = {"phase": "warm", "start": None, "end": None,
                        "handed": {}, "answered": 0, "trace_at": None}

        def stream():
            handed = st["handed"]
            while st["phase"] != "drain":
                if len(handed) < limit:
                    uid = self.uid
                    self.uid += 1
                    tokens, targets, mask, lam = self.traffic.request(uid)
                    r = Request(uid=uid, tokens=tokens, targets=targets,
                                mask=mask, lambdas=lam,
                                min_confidence=mix["min_confidence"])
                    handed[uid] = time.monotonic()
                    yield r
                else:
                    yield None
                self._tick(time.monotonic())

        self.uid = 0
        self._results = self.engine.serve(stream())

    def _tick(self, now):
        st = self.st
        if st["phase"] != "window":
            return
        t0, tracer = st["start"], self.tracer
        if tracer is not None:
            tracer.at(now - t0, *st["trace_at"])
        if now - t0 >= self.seconds:
            st["phase"] = "drain"
            st["end"] = now
            self.c1 = self._counters()

    def _warm_stream(self):
        """Serve ``warm_requests`` Results of the traffic through the
        stream, which stays open for the window."""
        st = self.st
        for res in self._results:
            st["handed"].pop(res.uid)
            st["answered"] += 1
            if st["answered"] >= self.mix["warm_requests"]:
                return
        raise RuntimeError("the serve() stream ended during warm-up")

    def window(self, seconds: float, tracer=None) -> dict:
        st, mix, seed = self.st, self.mix, self.seed
        self.seconds, self.tracer = seconds, tracer
        if tracer is not None:
            lead = max(0.0, (seconds - mix["trace_seconds"]) / 2)
            st["trace_at"] = (lead, lead + mix["trace_seconds"])
        keep_every = mix["check_keep_every"]
        handed = st["handed"]
        lat, n, failed, flops = [], 0, 0, 0.0
        by_expert = dict.fromkeys((e["name"] for e in self.cfg["experts"]), 0)
        st["start"] = time.monotonic()
        self.c0 = self._counters()
        st["phase"] = "window"
        for res in self._results:
            now = time.monotonic()
            t_h = handed.pop(res.uid)
            self._tick(now)
            if st["phase"] != "window" and now > st["end"]:
                continue
            n += 1
            lat.append(now - t_h)
            if res.failed:
                failed += 1
                continue
            flops += self._flops_of[res.expert]
            by_expert[res.expert] += 1
            if not res.cached:
                flops += self._flops_of[None]
            if _keep(res.uid, seed, keep_every):
                self.outputs[res.uid] = (res.expert, np.array(res.pred_losses),
                                         res.loss, np.array(res.predictions))
        if tracer is not None:
            tracer.finish()
        window_s = st["end"] - st["start"]
        self.attempted, self.failed = n, failed
        served = max(1, n - failed)
        self.notes["served_share"] = {k: v / served
                                      for k, v in by_expert.items()}
        c = {k: self.c1[k] - self.c0[k] for k in self.c0}
        self.layer = {"window_s": window_s, "engine": c, "flops": flops,
                      "dtype": self.cfg["dtype"]}
        return {"req_per_s": n / window_s,
                "latency_p95_ms": 1e3 * float(np.percentile(lat, 95))}

    def release(self):
        self.engine = self._results = None

    # ------------------------------------------------------------- check

    def sample(self) -> list:
        uids = sorted(self.outputs, key=lambda u: _order(u, self.seed))
        return sorted(uids[:self.mix["check_requests"]])

    def check(self, control: str | None = None) -> dict:
        """The compared numbers of the sampled Results: the program's
        (``control`` None) or those of the reference computed at
        ``control``'s precision in the program's place."""
        uids = self.sample()
        outputs = self.outputs
        if control is not None:
            outputs = checks.tryage_outputs(self.ref, self.cfg, self.weights,
                                            self.traffic, uids, self.device,
                                            control)
        return checks.tryage_numbers(self.ref, self.cfg, self.weights,
                                     self.traffic, uids, outputs,
                                     self.device)
