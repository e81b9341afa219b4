"""The system under test for ``tryage-bert11.json``: the port's
``TryageEngine`` over the router and the 11-expert library, built on
``meta`` from the configuration's sizes and given the benchmark's
weights (``load_state_dict(assign=True)``: the engine computes on the
very tensors the reference reads)."""

from __future__ import annotations

import torch

from harness.weights import subtree


def encoder_config(cfg: dict, m: dict):
    """The port's encoder config of the router or of an expert ``m``."""
    from repro_torch.models.common import AttnConfig, ModelConfig
    enc = cfg["prompt_encoder"]
    heads = m["num_attention_heads"]
    return ModelConfig(
        name=m.get("name", "tryage-router"),
        num_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        num_heads=heads, num_kv_heads=heads, d_ff=m["intermediate_size"],
        vocab_size=m["vocab_size"],
        attn=AttnConfig(rope_theta=enc["rope_theta"], causal=enc["causal"]),
        is_encoder=True, tie_embeddings=enc["tie_embeddings"],
        norm_kind="layernorm", norm_eps=m["layer_norm_eps"], act="gelu",
        dtype=cfg["dtype"])


def build(cfg: dict, ref, weights: dict, device) -> dict:
    """{"engine", "library", "router"} on ``device``."""
    from repro_torch.core.library import ExpertSpec, ModelLibrary
    from repro_torch.core.objective import (recency_constraint,
                                            size_constraint)
    from repro_torch.core.router import Router, RouterConfig
    from repro_torch.models.model import Model
    from repro_torch.serving import TryageEngine

    r = cfg["router"]
    rc = RouterConfig(n_models=r["n_models"], vocab_size=r["vocab_size"],
                      num_layers=r["num_hidden_layers"],
                      d_model=r["hidden_size"],
                      num_heads=r["num_attention_heads"],
                      d_ff=r["intermediate_size"],
                      head_hidden=r["head_hidden"])
    with torch.device("meta"):
        router = Router(rc, None)
    router.encoder = _model(encoder_config(cfg, r), weights, "router.encoder.")
    router.load_state_dict(subtree(weights, "router."), strict=True,
                           assign=True)
    experts = []
    for e in cfg["experts"]:
        mc = encoder_config(cfg, e)
        model = _model(mc, weights, f"experts.{e['name']}.")
        experts.append(ExpertSpec(e["name"], mc, {}, e["recency"],
                                  params=model,
                                  n_params=ref.n_params(cfg, e)))
    lib = ModelLibrary(experts)
    constraints = {"size": size_constraint, "recency": recency_constraint}
    eng = cfg["engine"]
    engine = TryageEngine(
        lib, router, rc, [constraints[c](lib) for c in cfg["constraints"]],
        max_batch=eng["max_batch"], buckets=eng["buckets"],
        decision_cache=eng["decision_cache"],
        cache_capacity=eng["cache_capacity"],
        lane_target=eng["lane_target"], max_wait_s=eng["max_wait_s"],
        device=device)
    return {"engine": engine, "library": lib, "router": router}


def _model(mc, weights: dict, prefix: str):
    from repro_torch.models.model import Model
    with torch.device("meta"):
        model = Model(mc, None)
    model.load_state_dict(subtree(weights, prefix), strict=True, assign=True)
    return model
