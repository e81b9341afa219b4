"""Chunked, checkpointed scan (``repro.models.scan_utils``).

The reference runs a long recurrence as an outer ``lax.scan`` over
chunks that carries only the chunk-boundary states, each chunk under
``jax.checkpoint``, so a backward keeps the boundary states and one
chunk's intermediates at a time.  Here each chunk runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant, so it nests in
the model's remat of unit groups) while grad is enabled, a plain loop
otherwise; on ``meta`` tensors the chunk loop is counted by trip count
(``launch.op_costs.counted_loop``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import op_costs
from repro_torch.sharding.context import recompute_context


def chunked_scan(step_chunk, init_state, xs, seq_axis: int, chunk: int,
                 name: str = "chunks"):
    """Scan ``step_chunk(state, x_chunk) -> (state, y_chunk)`` over
    chunks of ``chunk`` steps of the tensor ``xs`` along ``seq_axis``
    (T divisible by ``chunk``): (the final state, the ys concatenated
    along ``seq_axis``).  ``state`` is a pytree of tensors."""
    T = xs.shape[seq_axis]
    if T % chunk:
        raise ValueError(f"chunked_scan: chunk {chunk} does not divide "
                         f"T={T}")
    parts = xs.split(chunk, dim=seq_axis)
    body = step_chunk
    if torch.is_grad_enabled():
        def body(st, x):
            return checkpoint(step_chunk, st, x, use_reentrant=False,
                              context_fn=recompute_context)
    state, ys = op_costs.counted_loop(body, init_state, parts, name)
    return state, (ys[0] if len(ys) == 1 else torch.cat(ys, seq_axis))


def pick_chunk(T: int, target: int = 256) -> int:
    """Largest divisor of T that is <= target (>=1)."""
    c = min(target, T)
    while T % c:
        c -= 1
    return c
