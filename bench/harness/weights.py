"""Weights made by the benchmark: drawn from a seed on the device, in the
type they are served in, in a few large calls.

A weight list is ``(name, shape, role)`` (the references'
``param_specs``).  All of a list's values are drawn as one flat normal
buffer, then each weight, a view of it, is set to its role's scale:
``("matrix", fan_in)`` and ``("embed", d)`` by ``1 / sqrt(n)``,
``("scale",)`` to ``1 + 0.1 n``, ``("bias",)`` to ``0.1 n``.  The same
seed gives the same weights on the same device.
"""

from __future__ import annotations

import hashlib
import math

import torch

CHUNK = 1 << 30          # values a draw makes at once


def derive(seed: int, salt: str) -> int:
    """A 63-bit seed for the stream ``salt`` of a run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{salt}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _draw(n: int, seed: int, device, dtype) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(seed)
    out = torch.empty(n, device=device, dtype=dtype)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        out[lo:hi] = torch.randn(hi - lo, generator=gen, device=device,
                                 dtype=dtype)
    return out


@torch.no_grad()
def make(specs: list, draws: list, device, dtype) -> dict:
    """name -> tensor for every weight of ``specs``.  ``draws`` is a list
    of (seed, weight): the flat buffer is the weighted sum of a standard
    normal draw from each seed, before the roles' scales."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    flat = None
    for seed, weight in draws:
        d = _draw(total, seed, device, dtype)
        if flat is None:
            flat = d.mul_(weight) if weight != 1.0 else d
        else:
            flat.add_(d, alpha=weight)
            del d
    out, off = {}, 0
    for name, shape, role in specs:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        kind = role[0]
        if kind in ("matrix", "embed"):
            t.mul_(1.0 / math.sqrt(role[1]))
        elif kind == "scale":
            t.mul_(0.1).add_(1.0)
        elif kind == "bias":
            t.mul_(0.1)
        else:
            raise ValueError(f"{name}: unknown role {role!r}")
        out[name] = t
    return out


def subtree(weights: dict, prefix: str) -> dict:
    """The weights under ``prefix``, with the prefix taken off."""
    return {k[len(prefix):]: v for k, v in weights.items()
            if k.startswith(prefix)}
