"""Carry the JAX package's parameter trees into the port.

The JAX package keeps parameters as nested dicts of arrays; anything
``np.asarray`` accepts works here (numpy arrays, or JAX arrays handed
over by a caller — this module imports neither package).  The port's
modules keep the same leaf names and layouts, so the mapping is
structural:

* ``units`` — the JAX model stacks each unit's per-layer trees
  ``l0 .. l{P-1}`` along a leading unit axis and scans over it; slice
  ``u`` of ``units.l{j}`` becomes ``layers.{u * P + j}``, and the
  remainder layers ``rem.l{j}`` follow as ``layers.{U * P + j}``;
* attention ``wq``/``wk``/``wv`` (d, H, hd) and ``wo`` (H, hd, d),
  the Mamba, mLSTM and sLSTM ``mix`` leaves (``mix.A_log``, ...),
  layernorm ``scale``/``bias``, the MLP's ``wi``/``wo``, the MoE MLP's
  ``mlp.router``, ``mlp.wi``/``wg``/``wo`` and ``mlp.shared.*``, the
  tied ``embed.table`` and ``final_norm`` copy as they are;
* a router tree's ``encoder``, ``head`` and optional ``unc``.

``model_state`` and ``router_state`` map a tree, or a tree of its
gradients, to the port's parameter names, so tests can hold gradients
and trained weights leaf by leaf; ``model_tree`` and ``router_tree``
go the other way, from a port module to the JAX package's tree (layers
restacked into ``units.l{j}`` along the unit axis, then ``rem.l{j}``),
so a checkpoint the port saves (``checkpoint.save_pytree``) loads into
the JAX package's model.  ``model_from_checkpoint`` and
``router_from_checkpoint`` load such a checkpoint, saved by either
package, into the port.

Loading is strict: a missing or extra leaf, or a shape that differs,
raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint import load_pytree
from repro_torch.core.library import ExpertSpec, ModelLibrary
from repro_torch.core.router import Router, RouterConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import KINDS
from repro_torch.models.common import (AttnConfig, ModelConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.models.model import Model, count_params


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v if isinstance(v, torch.Tensor) \
                else np.asarray(v)


def model_state(tree: dict) -> dict:
    """A JAX model tree as the port's ``Model.state_dict()`` names."""
    units = tree.get("units", {})
    P = len(units)
    U = next(_flatten(units))[1].shape[0] if P else 0
    state = {}
    for name, arr in _flatten(tree):
        part, _, rest = name.partition(".")
        if part in ("units", "rem"):
            lj, _, leaf = rest.partition(".")
            j = int(lj[1:])
            if part == "units":
                for u in range(arr.shape[0]):
                    state[f"layers.{u * P + j}.{leaf}"] = arr[u]
            else:
                state[f"layers.{U * P + j}.{leaf}"] = arr
        else:
            state[name] = arr
    return state


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach().clone()
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' type: torch reads its bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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
        tensors[name] = _tensor(arr).to(own[name].dtype)
    # the module was built on meta: its parameters take these tensors
    module.load_state_dict(tensors, strict=True, assign=True)


def _fields(cls, obj):
    return None if obj is None else cls(
        **{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def model_config_from(cfg) -> ModelConfig:
    """The port's ``ModelConfig`` for a JAX-package config, read field
    by field (with its ``attn``, ``moe`` and ``ssm``); a block kind the
    port does not have raises."""
    kinds = set(cfg.layer_pattern)
    if not kinds <= set(KINDS):
        raise ValueError(f"{cfg.name}: block kind(s) "
                         f"{sorted(kinds - set(KINDS))} not in {KINDS}")
    nested = {"attn": AttnConfig, "moe": MoEConfig, "ssm": SSMConfig}
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)
              if f.name not in nested}
    return ModelConfig(**fields, **{name: _fields(cls, getattr(cfg, name))
                                    for name, cls in nested.items()})


def model_from_jax(tree: dict, cfg: ModelConfig, device=None) -> Model:
    """A ``Model`` holding the weights of a JAX model tree."""
    dev = resolve_device(device)
    with torch.device("meta"):     # shapes only: nothing drawn
        model = Model(cfg, None)
    _load(model, model_state(tree))
    return model.to(dev)


def router_from_jax(tree: dict, rc: RouterConfig, device=None) -> Router:
    """A ``Router`` holding the weights of a JAX router tree (with its
    ``unc`` head when the tree has one)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        router = Router(rc, None, uncertainty="unc" in tree)
    _load(router, router_state(tree))
    return router.to(dev)


def router_state(tree: dict) -> dict:
    """A JAX router tree (or a tree of its gradients) as the port's
    ``Router.state_dict()`` names."""
    state = {f"encoder.{k}": v for k, v in model_state(tree["encoder"]).items()}
    for head in ("head", "unc"):
        if head in tree:
            state.update((f"{head}.{k}", v) for k, v in _flatten(tree[head]))
    return state


def _put(tree: dict, name: str, value) -> None:
    *path, leaf = name.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def model_tree(model: Model) -> dict:
    """A port model's parameters as the JAX package's tree (the inverse
    of ``model_state``): CPU tensors, the full units' layers stacked
    along a leading unit axis into ``units.l{j}``, the remainder layers
    as ``rem.l{j}``."""
    cfg = model.cfg
    P = len(cfg.layer_pattern)
    U = cfg.num_layers // P
    tree: dict = {}
    stacks: dict = {}
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        part, _, rest = name.partition(".")
        if part != "layers":
            _put(tree, name, t)
            continue
        i, _, leaf = rest.partition(".")
        u, j = divmod(int(i), P)
        if u < U:
            stacks.setdefault(f"units.l{j}.{leaf}", [None] * U)[u] = t
        else:
            _put(tree, f"rem.l{int(i) - U * P}.{leaf}", t)
    for name, parts in stacks.items():
        _put(tree, name, torch.stack(parts))
    return tree


def router_tree(router: Router) -> dict:
    """A port router's parameters as the JAX package's tree (the
    inverse of ``router_state``): ``encoder``, ``head`` and, when the
    router has one, ``unc``."""
    tree = {"encoder": model_tree(router.encoder)}
    for name, t in router.state_dict().items():
        part, _, leaf = name.partition(".")
        if part != "encoder":
            _put(tree, f"{part}.{leaf}", t.detach().cpu())
    return tree


def model_from_checkpoint(path: str, cfg: ModelConfig, device=None) -> Model:
    """A ``Model`` holding a model checkpoint (``path`` without its
    ``.npz``/``.json``) saved by either package."""
    return model_from_jax(load_pytree(path), cfg, device)


def router_from_checkpoint(path: str, rc: RouterConfig,
                           device=None) -> Router:
    """A ``Router`` holding a router checkpoint saved by either
    package."""
    return router_from_jax(load_pytree(path), rc, device)


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
