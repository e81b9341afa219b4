"""Tiny versions of the benchmark's cells for the CPU tests: the same
files and drivers, at widths and loads a test run can hold."""

from __future__ import annotations

import copy
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (BENCH, os.path.join(os.path.dirname(BENCH), "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import core  # noqa: E402

SPEC = core.load_json(core.ROOT / "BENCHMARK.json")


def _encoder(layers, d, heads, ff, vocab, **kw):
    return dict(kw, num_hidden_layers=layers, hidden_size=d,
                num_attention_heads=heads, intermediate_size=ff,
                vocab_size=vocab, layer_norm_eps=1e-12)


def tiny_tryage(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["vocab_size"] = 64
    cfg["router"] = _encoder(1, 32, 2, 64, 72, head_hidden=16, n_models=3)
    cfg["experts"] = [
        _encoder(1, 32, 2, 64, 64, name="small", recency=0.5, focus=[]),
        _encoder(1, 48, 2, 96, 80, name="mid", recency=0.7,
                 focus=["github", "dm_math"]),
        _encoder(2, 64, 4, 128, 96, name="big", recency=0.9,
                 focus=["books"])]
    cfg["experts"][2]["layer_norm_eps"] = 1e-5
    cfg["engine"].update(max_batch=8)
    return cfg


def tiny_prompts(mix: dict) -> dict:
    mix = copy.deepcopy(mix)
    mix.update(prompt_len=24, pool=32, outstanding=24, warm_requests=32,
               stamp_tokens=3, trace_seconds=0.3, check_keep_every=2,
               check_requests=24)
    return mix


def tiny_lm(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    # a vocabulary and depth at which fp8's rounding flips greedy tokens
    # as it does at full size
    cfg.update(hidden_size=128, intermediate_size=256, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=4, vocab_size=2048,
               sliding_window=16)
    return cfg


def tiny_lm_mix(mix: dict) -> dict:
    mix = copy.deepcopy(mix)
    if mix["kind"] == "prefill":
        mix.update(prompt_len=12, cache_capacity=13, trace_seconds=0.3,
                   check_keep_every=1, check_requests=3)
    else:
        mix.update(batch=4, prompt_len=8, decode_tokens=12, cache_capacity=20,
                   prefill_rows=2, trace_seconds=0.3, check_sequences=3)
    return mix


def cell(name: str) -> core.Cell:
    """The workload ``name`` of BENCHMARK.json at tiny sizes."""
    c = core.Cell(SPEC, name)
    if c.cfg["system"] == "tryage":
        c.cfg, c.mix = tiny_tryage(c.cfg), tiny_prompts(c.mix)
    else:
        c.cfg, c.mix = tiny_lm(c.cfg), tiny_lm_mix(c.mix)
    return c

