"""Arithmetic shared by the per-layer metric readers (``bench/metrics``).

Each reader gets ``run``: the driver's window facts (``window_s``,
``flops``, ``dtype`` and the driver's own counters, such as ``engine``
for a served library or ``prefill_s``), ``trace`` (``harness.trace``'s
summary of the traced stretch) and ``costs`` (``costs.flops``).  A
reader returns a number, or None where it finds nothing to read; a
share of a peak or a roofline is never reported as 0 for want of data.
"""

from __future__ import annotations


def engine(run, key):
    c = run.get("engine")
    return None if c is None else c[key]


def ratio(num, den, scale=1.0):
    if num is None or not den:
        return None
    return scale * num / den


def mfu(run):
    """Model FLOPs of the window over the window at the type's peak, %."""
    if not run.get("flops"):
        return None
    peak = run["costs"].peak_flops(run["dtype"])
    return 100.0 * run["flops"] / (run["window_s"] * peak)


def idle_share(run):
    """Share of the traced stretch with nothing running on the device, %."""
    t = run["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(run, dtype, match):
    """The flash-attention calls of ``dtype`` in the traced stretch: the
    least time the card could take for them over their device time
    (kernels whose name ``match`` accepts), %."""
    t, costs = run["trace"], run["costs"]
    if not t:
        return None
    calls = [c for c in t["attention_calls"] if c[-1] == dtype]
    device_s = sum(s for name, s in t["kernel_s"].items() if match(name))
    if not calls or device_s <= 0:
        return None
    elt = 2 if dtype == "bfloat16" else 4
    bound = sum(costs.bound_seconds(*costs.flash_attention_cost(
        B, S, T, H, KV, hd, causal, window, elt), dtype)
        for B, S, T, H, KV, hd, causal, window, _ in calls)
    return 100.0 * bound / device_s
