"""Count the work of a torch program: the port's counterpart of
``repro.launch.hlo_loops`` and ``repro.launch.hlo_stats``.

The reference parses the compiled HLO of a jit'd step.  The port runs
eagerly, so there is no program text to parse: ``OpCounter`` is a
``TorchDispatchMode`` that sees every aten op the step dispatches (on
the ``meta`` device, where nothing runs, for the dry run; or on real
tensors) and adds up, with the reference's rules:

  * ``dot_flops``: 2 x output elements x contracted size of each
    ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and ``linear``;
  * ``traffic_bytes``: 2 x output bytes of each op whose result is at
    least ``TRAFFIC_MIN_BYTES`` (16 KiB), plus each dot's operand bytes
    (the reference assumes bf16 operands; here each operand's own
    type), views excluded (they move no data);
  * ``collective_bytes``: the output bytes of each collective
    (``c10d_functional`` / ``_c10d_functional`` ops, which DTensor's
    redistributions issue), and ``collectives``, bytes and counts by the
    reference's kinds (``repro.launch.hlo_stats.collective_stats``):
    0 on one card;
  * ``n_ops``, and ``op_histogram`` over the aten ops by name.

Under DTensor (a sharded step) the counts are per device, as the
reference's post-SPMD numbers are: a DTensor-level op reaches the mode
first, which hands it to DTensor uncounted (``NotImplemented``) with the
mode still open, so the ops DTensor runs on this rank's local shards,
and its collectives, are what is counted.

A Python loop is counted as often as it runs, so nothing needs the
reference's while-loop trip counts.

The hand-written kernels run outside aten (``ctypes``), so no dispatch
mode sees their work.  Each wrapper reports it instead: inside a
counted region (any open ``KernelLog``, which ``OpCounter`` opens)
``kernel_call`` records the kernel's FLOPs and bytes under its name
(``kernels.launches.WRAPPERS`` names them), from the cost formula in
the wrapper's module, and hides the aten ops inside it (a plain
version on the CPU, the output allocations) from the counters, so the
work is counted once.  ``dot_flops`` and ``traffic_bytes`` include the
kernels' work; ``kernels`` gives it per kernel.

``OpCounter`` also follows memory: each storage an op creates is live
until it is freed, and ``peak_bytes`` is the most bytes of such
storages alive at once (the dry run's temporary bytes).
"""

from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

TRAFFIC_MIN_BYTES = 16 * 1024

_aten = torch.ops.aten
DOTS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.linear}
# ops that only allocate: no data moves
ALLOCS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
          _aten.new_empty, _aten.new_empty_strided}

#: the open kernel logs, innermost last: the wrappers record into each
LOGS: list = []
_hidden = 0
_composite: dict = {}     # op -> whether it has a composite decomposition

# the reference's collective kinds (repro.launch.hlo_stats.COLLECTIVES)
# by functional collective op name
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _is_dtensor_op(args, kwargs) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor)
               for t in pytree.tree_leaves((args, kwargs)))


def _decomposes(func) -> bool:
    c = _composite.get(func)
    if c is None:
        c = _composite[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return c


class KernelLog:
    """Calls, FLOPs and bytes of each hand-written kernel while open."""

    def __init__(self):
        self.kernels: dict = {}

    def __enter__(self):
        LOGS.append(self)
        return self

    def __exit__(self, *exc):
        LOGS.remove(self)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)

    def totals(self) -> tuple[float, float]:
        """(FLOPs, bytes) of every kernel call logged."""
        return (sum(k["flops"] for k in self.kernels.values()),
                sum(k["bytes"] for k in self.kernels.values()))


@contextlib.contextmanager
def hidden():
    """Aten ops dispatched inside are part of a kernel's recorded work:
    the counters skip them (memory is still followed)."""
    global _hidden
    _hidden += 1
    try:
        yield
    finally:
        _hidden -= 1


def kernel_call(name: str, cost, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as one call of kernel ``name``: outside a
    counted region just the call; inside one, ``cost()`` (FLOPs, bytes)
    is recorded in every open log and the call's aten ops are hidden."""
    if not LOGS:
        return fn(*args, **kwargs)
    flops, nbytes = cost()
    for log in LOGS:
        log.add(name, flops, nbytes)
    with hidden():
        return fn(*args, **kwargs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Count dot FLOPs, traffic, ops and live storage bytes of the aten
    ops dispatched while open, and the kernels' logged work."""

    def __init__(self):
        super().__init__()
        self.aten_dot_flops = 0.0
        self.aten_traffic_bytes = 0.0
        self.n_ops = 0
        self.hist: collections.Counter = collections.Counter()
        self.log = KernelLog()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: set = set()
        self.collectives = {k: {"bytes": 0, "count": 0} for k in COLLECTIVES}

    def __enter__(self):
        self.log.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.log.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(args, kwargs):
            # DTensor runs it on the local shards, with this mode on the
            # stack: those ops are what is counted
            return NotImplemented
        if func._overloadpacket not in DOTS and _decomposes(func):
            # a composite op (einsum, matmul under inference_mode) reaches
            # the mode whole: count the ops it is made of instead
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        self._follow(outs)
        packet = func._overloadpacket
        if _hidden or func.is_view or packet in ALLOCS:
            return out
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            # a collective (or its wait): link bytes, not memory traffic
            kind = _COLLECTIVE_KIND.get(packet.__name__)
            if kind is not None:
                self.collectives[kind]["bytes"] += sum(_nbytes(t)
                                                       for t in outs)
                self.collectives[kind]["count"] += 1
            return out
        self.n_ops += 1
        self.hist[packet.__name__] += 1
        ob = sum(_nbytes(t) for t in outs)
        if ob >= TRAFFIC_MIN_BYTES:
            self.aten_traffic_bytes += 2.0 * ob
        if packet in DOTS and outs:
            mats = [a for a in args if isinstance(a, torch.Tensor)]
            if packet in (_aten.addmm, _aten.baddbmm):
                mats = mats[1:]                       # the bias is no operand
            lhs, rhs = mats[0], mats[1]
            self.aten_dot_flops += 2.0 * outs[0].numel() * lhs.shape[-1]
            self.aten_traffic_bytes += _nbytes(lhs) + _nbytes(rhs)
        return out

    def _follow(self, outs) -> None:
        """Count each storage first seen as an op's output as live until
        it is freed."""
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            self._live.add(key)
            n = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key, n)

    def _freed(self, key, n) -> None:
        self._live.discard(key)
        self.live_bytes -= n

    def totals(self, top: int = 25) -> dict:
        """The reference's ``loop_aware_totals`` keys, with the kernels'
        work included, plus ``op_histogram`` and the split."""
        kflops, kbytes = self.log.totals()
        hist = dict(sorted(self.hist.items(), key=lambda kv: -kv[1])[:top])
        coll = {k: dict(v) for k, v in self.collectives.items()}
        coll["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        coll["total_count"] = sum(v["count"] for v in self.collectives.values())
        return {"dot_flops": self.aten_dot_flops + kflops,
                "traffic_bytes": self.aten_traffic_bytes + kbytes,
                "collective_bytes": float(coll["total_bytes"]),
                "collectives": coll,
                "n_ops": self.n_ops,
                "op_histogram": hist,
                "aten_dot_flops": self.aten_dot_flops,
                "aten_traffic_bytes": self.aten_traffic_bytes,
                "kernels": {k: dict(v) for k, v in
                            sorted(self.log.kernels.items())}}
