"""Carry the JAX package's parameter trees into the port.

The JAX package keeps parameters as nested dicts of arrays; anything
``np.asarray`` accepts works here (numpy arrays, or JAX arrays handed
over by a caller — this module imports neither package).  The port's
modules keep the same leaf names and layouts, so the mapping is
structural:

* ``units`` — the JAX model stacks its per-layer tree along a leading
  layer axis and scans over it; slice ``i`` becomes ``layers.i``;
* attention ``wq``/``wk``/``wv`` (d, H, hd) and ``wo`` (H, hd, d),
  layernorm ``scale``/``bias``, the MLP's ``wi``/``wo``, the tied
  ``embed.table`` and ``final_norm`` copy as they are;
* a router tree's ``encoder``, ``head`` and optional ``unc``.

Loading is strict: a missing or extra leaf, or a shape that differs,
raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.library import ExpertSpec, ModelLibrary
from repro_torch.core.router import Router, RouterConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import AttnConfig, ModelConfig
from repro_torch.models.model import Model, count_params


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def model_state(tree: dict) -> dict:
    """A JAX model tree as the port's ``Model.state_dict()`` names."""
    state = {}
    for name, arr in _flatten(tree):
        if name.startswith("units.l0."):
            # one block per unit (layer_pattern ("attn",)): unstack
            leaf = name[len("units.l0."):]
            for i in range(arr.shape[0]):
                state[f"layers.{i}.{leaf}"] = arr[i]
        elif name.startswith("units."):
            raise ValueError(f"{name}: only one-block units are ported")
        else:
            state[name] = arr
    return state


def _load(module: nn.Module, state: dict) -> None:
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"unexpected {extra}")
    tensors = {}
    for name, arr in state.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the port "
                             f"has {tuple(own[name].shape)}")
        tensors[name] = torch.from_numpy(np.array(arr, copy=True))
    module.load_state_dict(tensors, strict=True)


def model_config_from(cfg) -> ModelConfig:
    """The port's ``ModelConfig`` for a JAX-package config, read field
    by field; the config must be a dense one-block-unit encoder."""
    if tuple(getattr(cfg, "layer_pattern", ("attn",))) != ("attn",) or any(
            getattr(cfg, "moe_pattern", (False,))):
        raise ValueError(f"{cfg.name}: only dense attention blocks are ported")
    attn = AttnConfig(**{f.name: getattr(cfg.attn, f.name)
                         for f in dataclasses.fields(AttnConfig)})
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig) if f.name != "attn"}
    return ModelConfig(attn=attn, **fields)


def model_from_jax(tree: dict, cfg: ModelConfig, device=None) -> Model:
    """A ``Model`` holding the weights of a JAX model tree."""
    dev = resolve_device(device)
    model = Model(cfg, torch.Generator().manual_seed(0))
    _load(model, model_state(tree))
    return model.to(dev)


def router_from_jax(tree: dict, rc: RouterConfig, device=None) -> Router:
    """A ``Router`` holding the weights of a JAX router tree (with its
    ``unc`` head when the tree has one)."""
    dev = resolve_device(device)
    router = Router(rc, torch.Generator().manual_seed(0),
                    uncertainty="unc" in tree)
    state = {f"encoder.{k}": v for k, v in model_state(tree["encoder"]).items()}
    for head in ("head", "unc"):
        if head in tree:
            state.update((f"{head}.{k}", v) for k, v in _flatten(tree[head]))
    _load(router, state)
    return router.to(dev)


def library_from_jax(library, device=None) -> ModelLibrary:
    """A port ``ModelLibrary`` with the experts, metadata and weights of
    a JAX-package library whose experts carry ``params``."""
    experts = []
    for e in library.experts:
        cfg = model_config_from(e.cfg)
        model = model_from_jax(e.params, cfg, device)
        experts.append(ExpertSpec(e.name, cfg, dict(e.train_mixture),
                                  e.recency, e.source, model,
                                  count_params(model)))
    return ModelLibrary(experts)
