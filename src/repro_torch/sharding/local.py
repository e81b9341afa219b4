"""Run work on each device's shards of DTensor inputs.

A hand-written kernel sees plain tensors, and its wrapper knows nothing
of meshes.  On a sharded step the model layer lays the kernel's DTensor
inputs out here so that each device holds whole independent problems
(a block of the batch, a block of the heads) and calls the wrapper on
the local shards through DTensor's ``local_map``: forward and backward
run per device, each launch is counted by the wrapper on each device,
and ``launch.op_costs`` records the work of one device.  Attention
(``attention_on_shards``, from ``models.attention``'s full-sequence and
decode paths) and the mLSTM scan (``scan_on_shards``, from
``models.ssm.mlstm_full``) go this way, and so does what DTensor's own
ops do not place safely in every torch release: the embedding lookup
(``embedding_on_shards``), a prefill cache's pad or roll
(``along_seq``) and the MoE experts (``models.moe``).  Helpers here
pick those layouts and read where a device's block sits in the global
array.
"""

from __future__ import annotations

import torch

from repro_torch.sharding.context import is_dtensor


def any_sharded(*ts) -> bool:
    """Whether any of ``ts`` is a DTensor with a sharded placement."""
    return any(is_dtensor(t) and any(p.is_shard() or p.is_partial()
                                     for p in t.placements) for t in ts)


def keep_shards(t, dims) -> tuple:
    """``t``'s placements with ``Shard(d)`` kept for ``d`` in ``dims``
    and every other placement (another dim's shard, a partial sum)
    replaced by ``Replicate()``."""
    from torch.distributed.tensor import Replicate
    return tuple(p if p.is_shard() and p.dim in dims else Replicate()
                 for p in t.placements)


def laid_out(t, where):
    """``t`` redistributed to ``where`` where it differs."""
    if tuple(t.placements) == tuple(where):
        return t
    return t.redistribute(t.device_mesh, where)


def mesh_dims_sharding(where, dim: int) -> tuple:
    """The mesh dims whose placement in ``where`` shards tensor ``dim``."""
    return tuple(i for i, p in enumerate(where)
                 if p.is_shard() and p.dim == dim)


def global_offset(shape, mesh, where, dim: int) -> int:
    """Where this rank's block of an array of ``shape`` laid out by
    ``where`` starts along ``dim``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    _, offset = compute_local_shape_and_global_offset(shape, mesh, where)
    return offset[dim]


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` whose gradient leaves contiguous.  DTensor takes a local
    gradient as laid out by its global strides; a plain version's
    autograd may hand back a permuted one (the kernels' gradients are
    contiguous already, and ``contiguous`` then copies nothing)."""
    return _ContiguousGrad.apply(t) if t.requires_grad else t


def kv_heads_for(h0: int, n_q: int, k0: int, n_kv: int, group: int):
    """The key/value heads that query heads ``h0 .. h0 + n_q - 1`` use
    (global head h takes kv head h // ``group``), as indices into a
    local k holding kv heads ``k0 .. k0 + n_kv - 1``: ``(start, n)``
    when they are ``n`` consecutive heads each serving ``n_q / n``
    consecutive query heads, else the list of one kv head per query
    head."""
    idx = [(h0 + j) // group - k0 for j in range(n_q)]
    if min(idx) < 0 or max(idx) >= n_kv:
        raise ValueError(f"attention: query heads {h0}..{h0 + n_q - 1} "
                         f"need kv heads outside the local {k0}.."
                         f"{k0 + n_kv - 1}")
    n = idx[-1] - idx[0] + 1
    if n_q % n == 0 and idx == [idx[0] + j // (n_q // n) for j in range(n_q)]:
        return idx[0], n
    return idx


def attention_on_shards(fn, q, k, v):
    """``fn(q, k, v)``, an attention over (B, S, H, hd) queries and
    (B, T, KV, hd) keys and values returning q's shape, on each device's
    shards of DTensors q, k, v: q keeps its batch and head blocks, the
    sequences and head_dim are gathered, and k and v keep q's batch
    blocks and its head blocks only where sharded exactly as q's heads
    (each device's groups are then the global ones).  Otherwise k and v
    are replicated and ``fn`` gets the kv heads the device's own query
    heads use (``kv_heads_for``); their gradients are then partial sums
    over the devices that share them."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    qw = keep_shards(q, (0, 2))
    same_heads = mesh_dims_sharding(k.placements, 2) == mesh_dims_sharding(
        qw, 2)
    kw = tuple(p if p.is_shard(0) or (p.is_shard(2) and same_heads)
               else Replicate() for p in qw)
    q, k, v = (laid_out(t, w) for t, w in ((q, qw), (k, kw), (v, kw)))
    H, KV = q.shape[2], k.shape[2]
    h0 = global_offset(q.shape, mesh, qw, 2)
    k0 = global_offset(k.shape, mesh, kw, 2)
    kg = tuple(Partial() if (qp.is_shard(2) and not kp.is_shard()) else kp
               for qp, kp in zip(qw, kw))

    def run(ql, kl, vl):
        ql, kl, vl = (contiguous_grad(t) for t in (ql, kl, vl))
        pick = kv_heads_for(h0, ql.shape[2], k0, kl.shape[2], H // KV)
        if isinstance(pick, tuple):
            if pick != (0, kl.shape[2]):
                kl, vl = (t.narrow(2, *pick) for t in (kl, vl))
        else:
            ix = torch.tensor(pick, device=kl.device)
            kl, vl = kl.index_select(2, ix), vl.index_select(2, ix)
        # DTensor views the result by its global strides: a permuted
        # local (a plain version's einsum) would not view; the kernel's
        # is contiguous already
        return fn(ql, kl, vl).contiguous()

    return local_map(run, out_placements=(qw,), in_placements=(qw, kw, kw),
                     in_grad_placements=(qw, kg, kg), device_mesh=mesh)(q, k, v)


def scan_on_shards(fn, q, k, v, i_pre, f_pre, state: dict):
    """``fn(q, k, v, i_pre, f_pre, state)`` -> (h, {"C", "n", "m"}), a
    recurrence over (B, S, H, ...) inputs from a (B, H, ...) state, on
    each device's shards of DTensors: the batch and the heads stay
    sharded where q shards them, everything else is gathered, and every
    input, the state included, is laid out alike.  Each (batch, head)
    block's recurrence is independent, so each device's forward and
    backward are the meshless ones on its blocks."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    seq = keep_shards(q, (0, 2))
    # the state's heads sit at dim 1
    st = tuple(Shard(1) if p.is_shard(2) else p for p in seq)
    args = [laid_out(t, seq) for t in (q, k, v, i_pre, f_pre)]
    args += [laid_out(state[n], st) for n in ("C", "n", "m")]

    def run(ql, kl, vl, il, fl, C, n, m):
        h, out = fn(ql, kl, vl, il, fl, {"C": C, "n": n, "m": m})
        return h, out["C"], out["n"], out["m"]

    where = (seq,) * 5 + (st,) * 3
    h, C, n, m = local_map(run, out_placements=(seq, st, st, st),
                           in_placements=where, in_grad_placements=where,
                           device_mesh=q.device_mesh)(*args)
    return h, {"C": C, "n": n, "m": m}


def embedding_on_shards(table, ids):
    """``table[ids]`` for DTensors, vocabulary-parallel: each device
    looks its ids up in its own block of the vocabulary (rows of other
    blocks give zeros, so the output is a partial sum over the devices
    that split the vocabulary), the embedding dim gathered, the ids
    keeping their batch blocks.  (DTensor's own index ops fail on such
    layouts in some torch releases.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    iw = keep_shards(ids, (0,))
    # a mesh dim that splits the batch keeps the whole vocabulary
    tw = tuple(Replicate() if i.is_shard() else t
               for t, i in zip(keep_shards(table, (0,)), iw))
    table, ids = laid_out(table, tw), laid_out(ids, iw)
    V = table.shape[0]
    v0 = global_offset(table.shape, mesh, tw, 0)
    out = tuple(Shard(0) if i.is_shard() else Partial() if t.is_shard()
                else Replicate() for t, i in zip(tw, iw))
    grad = tuple(Partial() if i.is_shard() else t for t, i in zip(tw, iw))

    def run(tl, il):
        il = il.long()
        if tl.shape[0] == V:
            return tl[il]
        mine = (il >= v0) & (il < v0 + tl.shape[0])
        rows = tl[torch.where(mine, il - v0, 0)]
        return rows * mine[..., None].to(rows.dtype)

    return local_map(run, out_placements=(out,), in_placements=(tw, iw),
                     in_grad_placements=(grad, iw), device_mesh=mesh)(
                         table, ids)


def along_seq(fn, t):
    """``fn(t)`` for a (B, S, ...) array whose ``fn`` changes dim 1
    alone (a pad, a roll), on each device's shard when ``t`` is a
    DTensor: dim 1 gathered, the other shards kept."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    where = tuple(p if p.is_shard() and p.dim != 1 else Replicate()
                  for p in t.placements)
    return local_map(fn, out_placements=(where,), in_placements=(where,),
                     device_mesh=t.device_mesh)(laid_out(t, where))
