"""Activation-sharding constraints via an ambient context
(``repro.sharding.context``).

Model code pins activation shardings explicitly with
``shard_act(x, logical_axes)``, which does nothing outside an
``activation_sharding(device_mesh, rules)`` context, or on a tensor
that is not a DTensor, so the same model code runs meshless.  Inside
the context a DTensor is redistributed to the placements its logical
axes give under the rules (DTensor's own propagation would otherwise
keep, for example, a full global batch on every device after an
embedding lookup).

``shard_zeros`` builds a zero array of a logical layout: a plain tensor
outside the context, else a DTensor that allocates only each device's
shard (a recurrent state, the MoE dispatch buffer).  ``distribute``
lays a full tensor, the same on every rank, out by given placements
without communication: each rank keeps its own block.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import (DEFAULT_RULES, LogicalRules,
                                        PartitionSpec, logical_to_spec,
                                        placements)

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)


def batch_sharding(mesh, ndim: int, dim_sizes=None,
                   rules: LogicalRules = DEFAULT_RULES) -> PartitionSpec:
    """The spec that shards the leading (batch) dim over the mesh's
    ``data`` axis and replicates the rest.  Divisibility-aware: pass
    ``dim_sizes`` to fall back to replication when the batch does not
    divide the data axis."""
    return logical_to_spec(mesh, ("batch",) + (None,) * (ndim - 1),
                           dim_sizes, rules)


def replicated_sharding(mesh) -> PartitionSpec:
    """The fully replicated spec."""
    return logical_to_spec(mesh, (), None, DEFAULT_RULES)


@contextlib.contextmanager
def activation_sharding(device_mesh, rules: LogicalRules):
    tok = _CTX.set((device_mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current():
    """(device mesh, rules) of the ambient context, or None."""
    return _CTX.get()


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the forward runs as
    it is, and its recomputation in the backward under the ambient
    context of the forward.  Autograd runs a CUDA backward on threads
    of its own, where the context variable is unset, so without this a
    remat'd group would recompute with no pins and no sharded
    allocations (on the CPU the backward runs on the caller's thread)."""
    ctx = _CTX.get()
    return (contextlib.nullcontext(),
            activation_sharding(*ctx) if ctx else contextlib.nullcontext())


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


@contextlib.contextmanager
def replicating(on: bool):
    """DTensor's implicit replication (a plain tensor meeting a DTensor
    counts as replicated) while open, when ``on``."""
    if not on:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


class _PinGrad(torch.autograd.Function):
    """Identity forward; the gradient leaves laid out as ``where``."""

    @staticmethod
    def forward(ctx, x, where):
        ctx.where = where
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.where:
            g = g.redistribute(g.device_mesh, ctx.where)
        return g, None


def shard_act(x, logical_axes: tuple, dim_sizes=None):
    """Constrain activation ``x`` to the ambient mesh/rules (no-op if
    none), and its gradient alike, as ``with_sharding_constraint``
    constrains the cotangent.  ``dim_sizes`` (default ``x.shape``) are
    the sizes the rules' divisibility is judged on: a flattened
    (heads x head_dim) dim is sharded by its heads alone, so that it
    unflattens."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x) or len(logical_axes) != x.ndim:
        return x
    mesh, rules = ctx
    target = placements(mesh, logical_to_spec(
        mesh, logical_axes, x.shape if dim_sizes is None else dim_sizes,
        rules))
    if tuple(x.placements) != target:
        x = x.redistribute(mesh, target)
    if x.requires_grad and torch.is_grad_enabled():
        x = _PinGrad.apply(x, target)
    return x


def distribute(t: torch.Tensor, device_mesh, where) -> torch.Tensor:
    """``t`` (the full tensor, the same on every rank) as a DTensor laid
    out by the placements ``where``: each rank keeps its own block,
    nothing is sent.  A block that is a view of ``t`` (a split of its
    first dim) is copied, so that ``t``'s memory goes with ``t``: a
    sharded model does not keep the whole one alive."""
    from torch.distributed.tensor import distribute_tensor
    out = distribute_tensor(t.detach(), device_mesh, where,
                            src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        out = DTensor.from_local(local.clone(), device_mesh, where,
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


def shard_zeros(shape, logical_axes: tuple, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Zeros of ``shape``: a plain tensor outside ``activation_sharding``,
    else a DTensor laid out by ``logical_axes`` whose ranks each
    allocate their own shard alone."""
    ctx = _CTX.get()
    if ctx is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, rules = ctx
    where = placements(mesh, logical_to_spec(mesh, logical_axes, shape,
                                             rules))
    local, _ = compute_local_shape_and_global_offset(shape, mesh, where)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh, where,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())
