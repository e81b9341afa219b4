"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a
stretch of the measured window, read into device busy time, time by
kernel, the longest idle gaps (named by the host's span and op across
each), and the shapes of the attention calls the window made.

The spans and the attention record are this file's, put around the
program's calls while a traced run lasts, not in the program: ``SPANS``
names the calls into each layer (the engine's Route and Execute
stages, the serving steps).  An untraced run calls the program as it
is."""

from __future__ import annotations

import time

import torch

NAME_CHARS = 160
# (module, attribute, span name): the layer calls a traced run annotates
SPANS = (("repro_torch.serving.pipeline", "ServingPipeline.admit",
          "span:route"),
         ("repro_torch.serving.pipeline", "ServingPipeline.flush",
          "span:execute"),
         ("repro_torch.launch.steps", "prefill_step", "span:prefill_step"),
         ("repro_torch.launch.steps", "serve_step", "span:serve_step"))


class Spans:
    """``torch.profiler.record_function`` around each call of ``SPANS``
    while installed."""

    def __init__(self):
        self._undo = []

    def install(self):
        import importlib
        for mod_name, attr, span in SPANS:
            owner = importlib.import_module(mod_name)
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            orig = owner.__dict__[name]

            def wrapped(*a, _orig=orig, _span=span, **kw):
                with torch.profiler.record_function(_span):
                    return _orig(*a, **kw)

            setattr(owner, name, wrapped)
            self._undo.append((owner, name, orig))

    def uninstall(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []


class AttentionCalls:
    """Records (B, S, T, H, KV, hd, causal, window, dtype) of each call
    the model layer makes to ``flash_attention`` while ``on``."""

    def __init__(self):
        self.on = False
        self.calls: list = []
        self._module = None
        self._orig = None

    def install(self):
        from repro_torch.models import attention as mod
        orig = mod.flash_attention

        def recorded(q, k, v, *, causal=True, window=0, **kw):
            if self.on:
                B, S, H, hd = q.shape
                self.calls.append((B, S, k.shape[1], H, k.shape[2], hd,
                                   bool(causal), int(window),
                                   str(q.dtype).replace("torch.", "")))
            return orig(q, k, v, causal=causal, window=window, **kw)

        self._module, self._orig = mod, orig
        mod.flash_attention = recorded

    def uninstall(self):
        if self._module is not None:
            self._module.flash_attention = self._orig
            self._module = None


class Trace:
    """``at(elapsed, lo, hi)`` traces the stretch [lo, hi) of a window's
    elapsed time, at the first calls past each end; ``finish()`` stops a
    stretch the window ended inside; ``summary`` reads it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = None
        self.attention = AttentionCalls()
        self.spans = Spans()
        self._summary = None
        self.state = "before"

    def install(self):
        self.attention.install()
        self.spans.install()

    def uninstall(self):
        self.spans.uninstall()
        self.attention.uninstall()

    def warm(self):
        """Start and stop the profiler once in set-up, so that its first
        start (CUPTI's) costs nothing inside the window."""
        self._profile().__enter__().__exit__(None, None, None)

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def at(self, elapsed: float, lo: float, hi: float):
        if self.state == "before" and elapsed >= lo:
            self._start()
        elif self.state == "on" and elapsed >= hi:
            self.finish()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self):
        self._sync()
        self.prof = self._profile()
        self.prof.start()
        self.attention.on = True
        self.state = "on"
        self.t0 = time.monotonic()

    def finish(self):
        if self.state != "on":
            return
        self._sync()
        self.t1 = time.monotonic()
        self.attention.on = False
        self.prof.stop()
        self.state = "done"

    @property
    def summary(self) -> dict:
        """The stretch read, once the window has closed (reading a trace
        takes host time the window must not pay)."""
        if self._summary is None:
            self._summary = self._read()
            self.prof = None
        return self._summary

    def _read(self) -> dict:
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a span's mirror on the device's timeline is no work
                if not e.name().startswith("span:"):
                    dev.append(span)
            elif e.duration_ns() > 0:
                host.append(span)
        window_s = self.t1 - self.t0
        by_name: dict = {}
        for s, t, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-9
        merged = []
        for s, t, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy_s = sum(t - s for s, t in merged) * 1e-9
        gaps = []
        for (_, a), (b, _) in zip(merged, merged[1:]):
            if b > a:
                gaps.append((b - a, a, b))
        gaps.sort(reverse=True)
        idle = [[_host_label(host, a, b), n * 1e-9] for n, a, b in gaps[:10]]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_s, "window_s": window_s,
                "kernel_s": by_name,
                "device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                "idle_gaps": idle,
                "attention_calls": list(self.attention.calls)}


def _host_label(host, a, b) -> str:
    """What the host did across the middle of the gap [a, b): the
    harness span, then the shortest op, that hold it."""
    mid = (a + b) // 2
    span, op = "host loop", None
    for s, t, name in host:
        if s <= mid < t:
            if name.startswith("span:"):
                span = name[5:]
            elif op is None or t - s < op[0]:
                op = (t - s, name)
    label = span if op is None else f"{span}: {op[1]}"
    return label[:NAME_CHARS]
