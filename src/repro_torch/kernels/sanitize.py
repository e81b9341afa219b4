"""Runtime sanitizer for the port's kernels: NaN/inf and out-of-range
checks, off by default (the port of ``repro.kernels.sanitize``).

Enable with ``REPRO_SANITIZE=1`` in the environment, ``--sanitize`` on
``launch/serve.py``, or ``set_sanitize(True)``; the switch is read on
every call.  With it off a wrapper pays for that one test and nothing
else.

The reference evaluates its conditions under ``checkify``; here each
check is an explicit reduction (``torch.isfinite(...).all()``, a range
test), all of one call's conditions are stacked into one bool tensor on
the device and brought to the host once, and the first one that failed,
in the order the checks were given, raises ``SanitizeError`` with the
reference's text.

The reference's checks skip inside an outer ``jax.jit``, where "the
caller owns sanitization" (its serving engine's decide and expert
paths, the jit'd model steps).  The port has no tracers, so the same
scope is explicit: under ``owned()`` the wrappers' checks skip.  They
also skip while a CUDA stream is capturing (a host sync is illegal
there) and for meta tensors (no values; the dry run).
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch

#: exp(m) over/underflows f32 beyond ~88; a stabilizer state outside
#: this band means the scan's renormalisation has already broken down.
MLSTM_M_RANGE = 80.0

_override: bool | None = None
_owners = 0
_lock = threading.Lock()


class SanitizeError(ValueError):
    """A failed sanitizer check (the reference raises checkify's
    ``JaxRuntimeError``, also a ``ValueError``)."""


def set_sanitize(on: bool | None) -> None:
    """Force the sanitizer on/off for this process (None: back to env)."""
    global _override
    _override = on


def sanitize_enabled() -> bool:
    if _override is not None:
        return _override
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() in (
        "1", "true", "on", "yes")


@contextlib.contextmanager
def owned():
    """A scope whose caller owns sanitization: the kernel wrappers'
    checks skip while any thread is inside one (a training step's
    backward runs its recomputed forwards in autograd's threads)."""
    global _owners
    with _lock:
        _owners += 1
    try:
        yield
    finally:
        with _lock:
            _owners -= 1


def owns(fn):
    """``fn`` run under ``owned()``: the counterpart of a function the
    reference jit's (an engine path, a model or training step)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with owned():
            return fn(*args, **kwargs)
    return wrapped


def wrapper_checks() -> bool:
    """Whether a kernel wrapper runs its checks now: the switch is on,
    no caller owns sanitization and no CUDA stream is capturing."""
    return (sanitize_enabled() and not _owners
            and not (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing()))


def check_finite(kernel: str, label: str, *tensors):
    """(condition, message): every value of ``tensors`` is finite."""
    conds = [torch.isfinite(t).all() for t in tensors]
    cond = torch.stack(conds).all() if len(conds) > 1 else conds[0]
    return cond, f"{kernel}: non-finite {label}"


def check_in_range(kernel: str, label: str, x, lo, hi):
    """(condition, message): lo <= x < hi everywhere (``x`` a tensor or
    a host number)."""
    if isinstance(x, torch.Tensor):
        cond = ((x >= lo) & (x < hi)).all()
    else:
        cond = bool(lo <= x < hi)
    return cond, f"{kernel}: {label} out of range [{lo}, {hi})"


def run_checks(*checks) -> None:
    """Raise ``SanitizeError`` on the first failed (condition, message)
    of ``checks``; device conditions reach the host in one transfer.
    Checks of meta tensors (no values) pass."""
    device = [c for c, _ in checks if isinstance(c, torch.Tensor)]
    if any(c.device.type == "meta" for c in device):
        return
    host = iter(torch.stack([c.to(device[0].device) for c in device])
                .cpu().tolist() if device else ())
    for cond, msg in checks:
        ok = next(host) if isinstance(cond, torch.Tensor) else cond
        if not ok:
            raise SanitizeError(msg)
