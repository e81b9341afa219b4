"""Driver for a served language model (``system: lm``): the port's
``launch/steps.py`` ``prefill_step`` and ``serve_step`` under
``tokens`` traffic.

``kind: prefill``: one request at a time, back to back; each prompt is
prefilled into a cache of ``cache_capacity`` slots and its first token
is the argmax of the last logits, read on the host.  A request is due
when the one before it finished; its time to first token runs from then
to when its token is on the host.  Requests that start in the window
finish in it, so the window ends with the last of them.

``kind: decode``: set-up prefills ``batch`` prompts in slices of
``prefill_rows`` and keeps their caches and first tokens; the window
decodes rounds of ``decode_tokens`` greedy ``serve_step``s, each round
from the kept caches, with no host sync between steps; it ends when the
card has finished the steps enqueued before the clock ran out.

Weights are drawn on the card from the run's seed, in the served type,
and the model is built around them by the configuration's file.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from costs import flops as costs
from harness import checks
from harness.traffic import token_prompt
from harness.weights import derive, make


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    def __init__(self, cfg, mix, ref, adapter, seed, device):
        self.cfg, self.mix, self.ref, self.adapter = cfg, mix, ref, adapter
        self.seed = seed
        self.device = torch.device(device)
        self.attempted = self.failed = 0
        self.phases, self.notes = {}, {}
        self.kind = mix["kind"]
        if self.kind not in ("prefill", "decode"):
            raise ValueError(f"lm traffic kind {self.kind!r}")
        s = ref.shape(cfg)
        self.shape = {"layers": s.layers, "d": s.d, "heads": s.heads,
                      "kv_heads": s.kv_heads, "ff": s.ff, "vocab": s.vocab}
        self.window_len = s.window

    def _prompt(self, index, rows=1):
        return token_prompt(self.mix, self.cfg["vocab_size"], self.seed,
                            index, rows)

    # ------------------------------------------------------------ set-up

    def setup(self):
        t0 = time.monotonic()
        specs = self.ref.param_specs(self.cfg)
        dtype = getattr(torch, self.cfg["dtype"])
        self.weights = make(specs, [(derive(self.seed, "weights"), 1.0)],
                            self.device, dtype)
        _sync(self.device)
        t1 = time.monotonic()
        self.model = self.adapter.build(self.cfg, self.ref, self.weights,
                                        self.device)["model"]
        t2 = time.monotonic()
        if self.kind == "prefill":
            self._prefill_setup()
        else:
            self._decode_setup()
        self.phases = {"weights": t1 - t0, "build": t2 - t1,
                       "warm": time.monotonic() - t2}

    def _prefill_setup(self):
        from repro_torch.launch.steps import prefill_step
        for i in range(self.mix["warm_requests"]):
            last, _ = prefill_step(self.model, {"tokens": self._prompt(-1 - i)},
                                   cache_capacity=self.mix["cache_capacity"],
                                   device=self.device)
            int(last.argmax(-1)[0])

    @torch.inference_mode()
    def _decode_setup(self):
        from repro_torch.launch.steps import prefill_step, serve_step
        mix, dev = self.mix, self.device
        B, S, rows = mix["batch"], mix["prompt_len"], mix["prefill_rows"]
        self.prompts = self._prompt(0, B)
        caches, first = None, []
        for lo in range(0, B, rows):
            last, st = prefill_step(
                self.model, {"tokens": self.prompts[lo:lo + rows]},
                cache_capacity=mix["cache_capacity"], device=dev)
            if caches is None:
                caches = [{k: torch.empty((B,) + t.shape[1:], dtype=t.dtype,
                                          device=dev) for k, t in c.items()}
                          for c in st]
            for c, layer in zip(caches, st):
                for k, t in layer.items():
                    c[k][lo:lo + rows].copy_(t)
            first.append(last.argmax(-1).to(torch.int32))
            del st, last
        self.caches = caches
        self.first = torch.cat(first)[:, None]
        tok, cache = self.first, self.caches
        for k in range(2):                  # the step's shape, warmed
            tok, cache = serve_step(self.model, cache, tok, S + k, device=dev)
        _sync(dev)

    # ------------------------------------------------------------ window

    def _trace_step(self, tracer, elapsed, seconds):
        if tracer is not None:
            lo = max(0.0, (seconds - self.mix["trace_seconds"]) / 2)
            tracer.at(elapsed, lo, lo + self.mix["trace_seconds"])

    def window(self, seconds: float, tracer=None) -> dict:
        if self.kind == "prefill":
            return self._prefill_window(seconds, tracer)
        return self._decode_window(seconds, tracer)

    def _prefill_window(self, seconds, tracer):
        from repro_torch.launch.steps import prefill_step
        mix, dev = self.mix, self.device
        S, cap = mix["prompt_len"], mix["cache_capacity"]
        every = mix["check_keep_every"]
        self.outputs = {}
        ttft, prefill = [], []
        start = done = time.monotonic()
        i = 0
        while done - start < seconds:
            self._trace_step(tracer, done - start, seconds)
            due = done
            prompt = self._prompt(i)
            t0 = time.monotonic()
            last, state = prefill_step(self.model, {"tokens": prompt},
                                       cache_capacity=cap, device=dev)
            _sync(dev)
            t1 = time.monotonic()
            tok = int(last.argmax(-1)[0])
            done = time.monotonic()
            ttft.append(done - due)
            prefill.append(t1 - t0)
            if derive(self.seed, f"keep:{i}") % every == 0:
                self.outputs[i] = (prompt, tok, last[0].float().cpu().numpy())
            del last, state
            i += 1
        if tracer is not None:
            tracer.finish()
        window_s = done - start
        self.attempted = i
        flops = i * costs.forward_flops(self.shape, 1, S, causal=True,
                                        window=self.window_len,
                                        logit_positions=1)
        self.layer = {"window_s": window_s, "flops": flops,
                      "dtype": self.cfg["dtype"],
                      "prefill_s": float(np.mean(prefill))}
        return {"ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)),
                "tokens_per_s": i * (S + 1) / window_s}

    def _decode_window(self, seconds, tracer):
        from repro_torch.launch.steps import serve_step
        mix, dev = self.mix, self.device
        B, S, K = mix["batch"], mix["prompt_len"], mix["decode_tokens"]
        steps, rounds, first_round, flops = 0, 0, None, 0
        start = time.monotonic()
        over = False
        while not over:
            rounds += 1
            tok, cache = self.first, self.caches
            served = [tok]
            for k in range(K):
                self._trace_step(tracer, time.monotonic() - start, seconds)
                tok, cache = serve_step(self.model, cache, tok, S + k,
                                        device=dev)
                served.append(tok)
                steps += 1
                flops += costs.forward_flops(
                    self.shape, B, 1, causal=True, window=self.window_len,
                    offset=S + k, logit_positions=1)
                if time.monotonic() - start >= seconds:
                    over = True
                    break
            if first_round is None:
                first_round = served
            del cache
        _sync(dev)
        window_s = time.monotonic() - start
        if tracer is not None:
            tracer.finish()
        self.served = torch.cat(first_round, 1).cpu().numpy()
        self.attempted = B * rounds
        self.layer = {"window_s": window_s, "flops": flops,
                      "dtype": self.cfg["dtype"],
                      "decode_step_s": window_s / steps}
        return {"tokens_per_s": steps * B / window_s}

    def release(self):
        self.model = self.caches = self.first = None

    # ------------------------------------------------------------- check

    def _pick(self, keys, n):
        return sorted(sorted(keys, key=lambda k: derive(self.seed,
                                                        f"pick:{k}"))[:n])

    def check(self, control: str | None = None) -> dict:
        cfg, mix = self.cfg, self.mix
        S = mix["prompt_len"]
        if self.kind == "prefill":
            # one served token a request: its gap is at most twice the
            # last logits' error, which is what is compared
            idx = self._pick(self.outputs, mix["check_requests"])
            seqs = np.concatenate([self.outputs[i][0] for i in idx])
            last = np.stack([self.outputs[i][2] for i in idx])
            return checks.lm_logit_numbers(self.ref, cfg, self.weights, seqs,
                                           last, self.device, control)
        rows = self._pick(range(mix["batch"]), mix["check_sequences"])
        served = self.served[rows]
        K = served.shape[1] - 1
        seqs = np.concatenate([self.prompts[rows], served[:, :K]], axis=1)
        positions = list(range(S - 1, S + K))
        return checks.lm_numbers(self.ref, cfg, self.weights, seqs,
                                 positions, served, self.device,
                                 control=control)
