"""Training, prefill and greedy decode steps for a model of the zoo:
the counterparts of ``repro.launch.steps.build_train_step``,
``build_prefill_step`` and ``build_decode_step``, eager, without jit.

Each runs on the model's device and never moves the model.  ``device``
names where the caller expects it to be: left unset it is the card, so
without a CUDA device they raise rather than run on the CPU.

With ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``, one rank
per device, ``launch.mesh.device_mesh``) a step runs sharded, as the
reference's steps run under their in_shardings: the model's parameters
and the AdamW moments are DTensors laid out by their logical axes
(``shard_model``, ``shard_opt_state``), the batch and the decode state
are laid out on entry (``shard_batch``, ``shard_decode_state``; a plain
tensor is taken as the full array, the same on every rank), and the
step runs under ``sharding.activation_sharding`` with the rules of
``rules_for`` and DTensor's implicit replication (positions and masks
built inside the model are plain tensors, replicated).  The kernels run
on each device's shards (the model layer calls their wrappers through
``local_map``, ``sharding.local``).  A sharded
step returns DTensors laid out as the reference's step outputs are: the
loss replicated, the last logits by ("batch", "vocab"), next tokens by
("batch", "seq") and the state by its specs.  With no mesh each step
runs as it always has.

``PerfKnobs`` keeps the reference's knobs: ``microbatch``, ``remat``,
``unit_group``, ``rule_overrides`` (extra logical rules, read with a
mesh), and ``moment_dtype``, which must stay ``"float32"``: the
reference's update computes f32 moments whatever it says
(``src/repro/optim/adamw.py`` lines 27-31 and 45-47; the knob reaches
only its abstract shardings).  ``attn_impl`` and ``donate`` are not
ported: the attention is the kernel's, and the step updates the model
in place.

The three steps own sanitization (``kernels.sanitize.owned``), as the
reference's jit'd steps do: the kernel wrappers' checks skip inside.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from repro_torch.device import module_device, resolve_device
from repro_torch.kernels import sanitize
from repro_torch.launch import specs as specs_lib
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import OptState, adamw_update, grads_of
from repro_torch.sharding import (DEFAULT_RULES, MULTIPOD_RULES, LogicalRules,
                                  activation_sharding, logical_to_spec,
                                  placements)
from repro_torch.sharding.context import (distribute, is_dtensor,
                                          replicating, shard_act)


@dataclasses.dataclass
class PerfKnobs:
    microbatch: int = 1
    moment_dtype: str = "float32"
    remat: bool = True
    unit_group: int = 1      # sqrt-depth remat: boundaries every g units
    # extra logical-rule overrides, e.g. {"expert": ("data", "model")}
    rule_overrides: dict | None = None

    def __post_init__(self):
        if self.moment_dtype != "float32":
            raise ValueError(
                f"PerfKnobs: moment_dtype {self.moment_dtype!r}; the moments "
                f"are float32 as the reference's update computes them "
                f"whatever the knob says (src/repro/optim/adamw.py:27-31,"
                f"45-47)")
        if self.microbatch < 1 or self.unit_group < 1:
            raise ValueError(f"PerfKnobs: microbatch {self.microbatch} and "
                             f"unit_group {self.unit_group} must be >= 1")


def rules_for(mesh, knobs: PerfKnobs | None = None) -> LogicalRules:
    """The multipod rules on a mesh with a ``pod`` axis, else the
    default ones, with ``knobs.rule_overrides`` laid over them."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    base = MULTIPOD_RULES if "pod" in names else DEFAULT_RULES
    if knobs and knobs.rule_overrides:
        return LogicalRules(rules={**base.rules, **knobs.rule_overrides})
    return base


def _lay(t, mesh, logical, rules):
    """``t`` laid out by ``logical``: a plain tensor is distributed (each
    rank keeps its block), a DTensor redistributed where it differs."""
    where = placements(mesh, logical_to_spec(mesh, logical, t.shape, rules))
    if not is_dtensor(t):
        return distribute(t, mesh, where)
    return t if tuple(t.placements) == where else t.redistribute(mesh, where)


@torch.no_grad()
def shard_model(model, mesh, rules: LogicalRules):
    """Lay every parameter of ``model`` out on ``mesh`` by its logical
    axes (``models.model.model_logical``), in place; returns the model."""
    logical = model_lib.model_logical(model.cfg)
    for mname, mod in model.named_modules():
        for pname, p in list(mod._parameters.items()):
            name = f"{mname}.{pname}" if mname else pname
            mod._parameters[pname] = nn.Parameter(
                _lay(p.detach(), mesh, logical[name], rules),
                requires_grad=p.requires_grad)
    return model


@torch.no_grad()
def shard_opt_state(opt: OptState, model) -> OptState:
    """The AdamW moments laid out as ``model``'s (sharded) parameters."""
    def lay(name, m):
        p = model.get_parameter(name)
        if not is_dtensor(p):
            return m
        if is_dtensor(m):
            return m.redistribute(p.device_mesh, p.placements)
        return distribute(m, p.device_mesh, p.placements)
    return OptState(step=opt.step,
                    mu={n: lay(n, m) for n, m in opt.mu.items()},
                    nu={n: lay(n, v) for n, v in opt.nu.items()})


def shard_batch(batch: dict, mesh, rules: LogicalRules) -> dict:
    """A step's inputs laid out by ``launch.specs.INPUT_LOGICAL``."""
    return {k: _lay(v, mesh, specs_lib.INPUT_LOGICAL[k], rules)
            for k, v in batch.items()}


def shard_decode_state(state: list, cfg, mesh, rules: LogicalRules) -> list:
    """Per-layer decode states laid out by ``decode_state_logical``."""
    logical = model_lib.decode_state_logical(cfg)
    return [{k: _lay(t, mesh, logical[i][k], rules) for k, t in st.items()}
            for i, st in enumerate(state)]


@contextlib.contextmanager
def _sharded(mesh, rules):
    """The sharded steps' scope: the activation pins and DTensor's
    implicit replication of plain tensors; nothing without a mesh."""
    if mesh is None:
        yield
        return
    with activation_sharding(mesh, rules), replicating(True):
        yield


def _serving(mesh):
    """Prefill and decode run under ``inference_mode``; a sharded one
    under ``no_grad``, since a DTensor made outside inference mode (a
    state laid out by ``shard_decode_state``) cannot be viewed inside
    it."""
    return torch.inference_mode() if mesh is None else torch.no_grad()


def _replicated(t, mesh):
    from torch.distributed.tensor import Replicate
    return t.redistribute(mesh, (Replicate(),) * mesh.ndim)


def _inputs(batch, dev) -> dict:
    return {k: v if is_dtensor(v) else torch.as_tensor(v, device=dev)
            for k, v in batch.items()}


@sanitize.owns
def train_step(model, opt: OptState, batch, *, knobs: PerfKnobs = PerfKnobs(),
               lr=5e-5, device=None, mesh=None):
    """One AdamW step of ``lm_loss`` (weight decay 1e-5) on ``batch``
    (``{"tokens"}``, ``{"tokens", "mask"}``, or for the MLM, vlm and audio
    families ``{"embeds", "targets", "mask"}``, numpy arrays or tensors):
    ``model`` and ``opt`` are updated in place; returns the loss (an f32
    scalar tensor).  With ``microbatch`` n > 1 the batch is split along
    its first axis, the gradients are added in f32 in microbatch order
    and divided by n, as the loss is; with n = 1 the gradients reach
    AdamW in the parameters' type, as in the reference (its clip rounds
    the scale to the gradients' type).  With ``mesh`` the model and
    ``opt`` must be sharded already (``shard_model``,
    ``shard_opt_state``); each microbatch is laid out as it is cut, and
    the loss comes back as a replicated DTensor."""
    dev = _on_device(model, device)
    inputs = _inputs(batch, dev)
    n = knobs.microbatch
    rules = rules_for(mesh, knobs) if mesh is not None else None

    def loss_of(b):
        model.zero_grad(set_to_none=True)
        if mesh is not None:
            b = shard_batch(b, mesh, rules)
        loss, _ = model_lib.lm_loss(model, b, remat=knobs.remat,
                                    unit_group=knobs.unit_group)
        loss.backward()
        return loss.detach()

    with torch.enable_grad(), _sharded(mesh, rules):
        if n == 1:
            loss = loss_of(inputs)
            grads = grads_of(model)
        else:
            B = next(iter(inputs.values())).shape[0]
            if B % n:
                raise ValueError(f"train_step: batch {B} does not split into "
                                 f"{n} microbatches")
            grads = {name: torch.zeros_like(p, dtype=torch.float32)
                     for name, p in model.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                part = {k: v.reshape(n, B // n, *v.shape[1:])[i]
                        for k, v in inputs.items()}
                loss = loss + loss_of(part).float()
                for name, g in grads_of(model).items():
                    grads[name] += g.float()
            grads = {name: g / n for name, g in grads.items()}
            loss = loss / n
    with _sharded(mesh, rules):
        _, new = adamw_update(model, grads, opt, lr=lr, weight_decay=1e-5)
    opt.step = new.step          # mu and nu were updated in place
    model.zero_grad(set_to_none=True)
    return loss if mesh is None else _replicated(loss, mesh)


def _on_device(model, device) -> torch.device:
    dev = resolve_device(device)
    have = module_device(model)
    if have != dev:
        raise ValueError(f"the model is on {have}, not on {dev}")
    return dev


@sanitize.owns
def prefill_step(model, batch, *, cache_capacity=None, device=None,
                 mesh=None, knobs: PerfKnobs = PerfKnobs()):
    """batch: {"tokens": (B, S) ints} or, for the modality stubs,
    {"embeds": (B, S, d)}.  Returns (the last position's logits (B, V)
    in f32, per-layer states); full-attention caches hold
    ``cache_capacity`` slots (default S: pass S + the tokens to
    decode).  With ``mesh`` the model must be sharded; the state comes
    back laid out by its specs."""
    dev = _on_device(model, device)
    name = "embeds" if "embeds" in batch else "tokens"
    inputs = _inputs({name: batch[name]}, dev)
    rules = rules_for(mesh, knobs) if mesh is not None else None
    with _serving(mesh), _sharded(mesh, rules):
        if mesh is not None:
            inputs = shard_batch(inputs, mesh, rules)
        logits, state = model_lib.prefill(model, inputs,
                                          cache_capacity=cache_capacity)
        last = logits[:, -1].float()
        if mesh is None:
            return last, state
        return (shard_act(last, ("batch", "vocab")),
                shard_decode_state(state, model.cfg, mesh, rules))


@sanitize.owns
def serve_step(model, state, tokens, index, *, device=None, mesh=None,
               knobs: PerfKnobs = PerfKnobs()):
    """One greedy decode step: tokens (B, 1) at position ``index``.
    Returns (next tokens (B, 1) int32, per-layer states).  With
    ``mesh`` the model must be sharded; tokens and state are laid out on
    entry and come back laid out by their specs."""
    dev = _on_device(model, device)
    tokens = _inputs({"tokens": tokens}, dev)
    rules = rules_for(mesh, knobs) if mesh is not None else None
    with _serving(mesh), _sharded(mesh, rules):
        if mesh is not None:
            tokens = shard_batch(tokens, mesh, rules)
            state = shard_decode_state(state, model.cfg, mesh, rules)
        logits, state = model_lib.decode_step(model, tokens, state, index)
        # on a mesh each device reads its rows' whole vocabulary
        logits = shard_act(logits, ("batch", None))
        nxt = logits.argmax(dim=-1).to(torch.int32)[:, None]
        if mesh is None:
            return nxt, state
        return (shard_batch({"tokens": nxt}, mesh, rules)["tokens"],
                shard_decode_state(state, model.cfg, mesh, rules))
