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

Loops are counted by trip count, as the reference weights each while
body (``repro.launch.hlo_loops``).  A Python loop runs as often as it
loops, which on ``meta`` tensors costs a dispatch an op for nothing: an
sLSTM over 32,768 steps would take half an hour to trace.  Inside a
``repeat(n)`` scope everything the counters add (ops, the histogram, dot
FLOPs, traffic, collectives, each kernel's calls, FLOPs and bytes)
counts n times; scopes nest by multiplying.  ``counted_loop`` runs a
loop of n >= 3 iterations on ``meta`` as its first iteration, one middle
one under ``repeat(n - 2)`` and its last (the first reads a state that
may take no gradient; the last's state is read by no further
iteration).  Under autograd a pair of identity functions around the
middle iteration opens the same scope in the backward
(``_Leave``, whose backward runs before any of the middle iteration's,
and ``_Enter``, whose backward runs after all of them: the engine runs
nodes latest-created first).  The bytes each skipped iteration keeps
alive (its output, what autograd saves for it, measured on the traced
one) are held by one ``meta`` buffer until the middle iteration's
backward ends, so ``peak_bytes`` follows the unrolled loop.  On other
devices every iteration runs, as before.

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
import math
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
#: the open counters, innermost last
COUNTERS: list = []
_hidden = 0
#: the open ``repeat`` scopes' trip counts, innermost last, and their
#: product: what each count added counts for
_REPEATS: list = []
_mult = 1
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
        k["calls"] += _mult
        k["flops"] += _mult * float(flops)
        k["bytes"] += _mult * float(nbytes)

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


def _push(n: int) -> None:
    global _mult
    _REPEATS.append(n)
    _mult = math.prod(_REPEATS)


def _pop(n: int) -> None:
    global _mult
    if not _REPEATS or _REPEATS[-1] != n:
        raise RuntimeError(f"op_costs: closing a repeat({n}) scope, but the "
                           f"open ones are {_REPEATS}")
    _REPEATS.pop()
    _mult = math.prod(_REPEATS)


@contextlib.contextmanager
def repeat(n: int):
    """Everything the counters add while open counts ``n`` times (an
    iteration traced once for ``n``); scopes nest by multiplying."""
    if n < 1:
        raise ValueError(f"repeat: trip count {n} < 1")
    _push(n)
    try:
        yield
    finally:
        _pop(n)


def kernel_call(name: str, cost, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as one call of kernel ``name``: outside a
    counted region just the call; inside one, ``cost()`` (FLOPs, bytes)
    is recorded in every open log and the call's aten ops are hidden."""
    if not LOGS:
        return fn(*args, **kwargs)
    flops, nbytes = cost()
    for log in LOGS:
        log.add(name, flops, nbytes)
    try:
        with hidden():
            return fn(*args, **kwargs)
    finally:
        if not _hidden:
            for c in COUNTERS:
                c._settle()


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
        self._pending: list = []
        self.collectives = {k: {"bytes": 0, "count": 0} for k in COLLECTIVES}
        #: (name, trip count) -> runs counted, runs traced, iterations
        #: traced of each loop ``counted_loop`` counted by trip count
        self.loops: dict = {}

    def __enter__(self):
        self.log.__enter__()
        COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            COUNTERS.remove(self)
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
                self.collectives[kind]["bytes"] += _mult * sum(
                    _nbytes(t) for t in outs)
                self.collectives[kind]["count"] += _mult
            return out
        self.n_ops += _mult
        self.hist[packet.__name__] += _mult
        ob = sum(_nbytes(t) for t in outs)
        if ob >= TRAFFIC_MIN_BYTES:
            self.aten_traffic_bytes += _mult * 2.0 * ob
        if packet in DOTS and outs:
            mats = [a for a in args if isinstance(a, torch.Tensor)]
            if packet in (_aten.addmm, _aten.baddbmm):
                mats = mats[1:]                       # the bias is no operand
            lhs, rhs = mats[0], mats[1]
            self.aten_dot_flops += (_mult * 2.0 * outs[0].numel()
                                    * lhs.shape[-1])
            self.aten_traffic_bytes += _mult * (_nbytes(lhs) + _nbytes(rhs))
        return out

    def _follow(self, outs) -> None:
        """Count each storage first seen as an op's output as live until
        it is freed.  Inside a kernel's call only the storages that
        outlive it count (``_settle``): a kernel allocates its outputs
        and what it keeps, not its plain version's temporaries."""
        for t in outs:
            st = t.untyped_storage()
            if _hidden:
                self._pending.append(weakref.ref(st))
            else:
                self._follow_storage(st)

    def _follow_storage(self, st) -> None:
        key = st._cdata
        if key in self._live:
            return
        self._live.add(key)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key, n)

    def _settle(self) -> None:
        """Follow the storages made in a kernel's call that are still
        alive at its end."""
        pending, self._pending = self._pending, []
        for ref in pending:
            st = ref()
            if st is not None:
                self._follow_storage(st)

    def _freed(self, key, n) -> None:
        self._live.discard(key)
        self.live_bytes -= n

    def totals(self, top: int | None = 25) -> dict:
        """The reference's ``loop_aware_totals`` keys, with the kernels'
        work included, plus ``op_histogram`` (its ``top`` ops, None: all),
        the split and ``loops``."""
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
                            sorted(self.log.kernels.items())},
                "loops": [{"name": name, "trip_count": n, **v}
                          for (name, n), v in sorted(self.loops.items())]}


# ------------------------------------------------- loops by trip count

class _Scope:
    """One middle iteration's scope: its trip count, whether its
    backward is open, and the buffer that holds the skipped iterations'
    bytes until the backward ends."""

    def __init__(self, n: int):
        self.n = n
        self.open = False
        self.held = None


class _Enter(torch.autograd.Function):
    """Identity on the middle iteration's inputs (the carried state and
    every skipped iteration's input after its own); its backward closes
    the scope, frees the held bytes and gives the skipped iterations'
    inputs their gradients' stand-ins."""

    @staticmethod
    def forward(ctx, scope, n_used, *ts):
        ctx.set_materialize_grads(False)
        ctx.scope, ctx.n_used = scope, n_used
        x = ts[n_used - 1]
        ctx.x = (x.shape, x.dtype, x.device)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        scope = ctx.scope
        if not scope.open:
            raise RuntimeError(
                "counted_loop: the middle iteration's backward ran without "
                "the gradient of its carried state")
        _pop(scope.n)
        scope.open, scope.held = False, None
        used, skipped = gs[:ctx.n_used], gs[ctx.n_used:]
        if skipped and ctx.needs_input_grad[2 + ctx.n_used]:
            shape, dtype, device = ctx.x
            skipped = torch.empty((len(skipped), *shape), dtype=dtype,
                                  device=device).unbind(0)
        return (None, None, *used, *skipped)


class _Leave(torch.autograd.Function):
    """Identity on the middle iteration's carried state out; keeps the
    held buffer for the backward (``save_for_backward``, so that under a
    checkpoint its recomputed size is what is kept), where it opens the
    scope."""

    @staticmethod
    def forward(ctx, scope, held, *ts):
        ctx.set_materialize_grads(False)
        ctx.scope = scope
        ctx.save_for_backward(held)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        scope = ctx.scope
        (scope.held,) = ctx.saved_tensors
        scope.open = True
        _push(scope.n)
        return (None, None, *gs)


def _live() -> int:
    return COUNTERS[-1].live_bytes if COUNTERS else 0


def _counted(x) -> bool:
    if x.device.type != "meta":
        return False
    from torch.distributed.tensor import DTensor
    return not isinstance(x, DTensor)


def counted_loop(body, carry, xs, name: str):
    """``carry, y = body(carry, x)`` for each ``x`` of the sequence
    ``xs``: (the last carry, the list of y).  ``carry`` is a pytree of
    tensors, each ``x`` and ``y`` a tensor.  On ``meta`` tensors with 3
    or more iterations the loop is counted by trip count (the module's
    docstring); the skipped iterations' ys are views of one buffer."""
    n = len(xs)
    if n < 3 or not _counted(xs[0]):
        ys = []
        for x in xs:
            carry, y = body(carry, x)
            ys.append(y)
        return carry, ys
    for c in COUNTERS:
        rec = c.loops.setdefault((name, n), {"runs": 0, "traced_runs": 0,
                                             "iterations_traced": 0})
        rec["runs"] += _mult
        rec["traced_runs"] += 1
        rec["iterations_traced"] += 3
    carry, y0 = body(carry, xs[0])
    scope = _Scope(n - 2)
    leaves, spec = pytree.tree_flatten(carry)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*leaves, xs[1]))
    before = _live()
    x1 = xs[1]
    if grad:
        outs = _Enter.apply(scope, len(leaves) + 1, *leaves, *xs[1:n - 1])
        carry = pytree.tree_unflatten(list(outs[:len(leaves)]), spec)
        x1 = outs[len(leaves)]
        del outs
    del leaves
    with repeat(n - 2):
        carry, y1 = body(carry, x1)
    del x1
    k = n - 3
    per = max(_live() - before, _nbytes(y1))
    held = torch.empty(k * per, dtype=torch.uint8, device=y1.device)
    ys = []
    if k:
        ys = list(held[:k * _nbytes(y1)].view(y1.dtype)
                  .view(k, *y1.shape).unbind(0))
    if grad:
        leaves, spec = pytree.tree_flatten(carry)
        carry = pytree.tree_unflatten(
            list(_Leave.apply(scope, held[:0], *leaves)), spec)
        del leaves
    del held
    carry, y_last = body(carry, xs[-1])
    return carry, [y0, y1, *ys, y_last]
