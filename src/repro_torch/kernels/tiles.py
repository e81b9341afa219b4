"""The launch-config table the kernel wrappers consult (the port of
``repro.kernels.tiles``).

``launch/autotune.py`` times each kernel's launch geometries on the
card per (kernel, batch) and writes the winners to
``experiments/tryage/tile_table_torch.json`` (override with the
``REPRO_TORCH_TILE_TABLE`` env var or ``set_table_path``, e.g. from
``launch/serve.py --tile-table``).  The wrappers' plans call
``tile_for`` only where the caller left the geometry unset: a missing
or unreadable table, an unknown kernel or another card's entries all
give the plan's default, so a consult never raises, and with no table
every kernel launches the geometry it launches without one.  The file
is the port's own: the JAX package's ``tile_table.json`` holds Pallas
block sizes, which mean nothing to these kernels.

The geometry a table can set (the wrappers check each entry and fall
back to the default on one the kernel cannot take):

* ``router_score`` / ``router_cascade``: ``k_groups``, the hidden
  layer's split of each dot product over a block's threads (the thread
  count follows from it);
* ``flash_attention``: ``warps`` per block, 1, 2 or 4 (16 query rows
  each; in the bf16 instances above head_dim 128 a pair of warps holds
  the 16 rows, so the block has twice as many);
* ``mlstm_scan``: ``chunk``, the forward's chunk length L (at most 64,
  dividing S); the backward takes the forward's chunk.

Entries are keyed by the card: ``cuda:<torch.cuda.get_device_name()>``,
or ``cpu`` without one, so a table tuned on one card is never read on
another.  Schema (see ``launch.autotune.write_table``)::

    {"version": 1,
     "cuda:NVIDIA H100 80GB HBM3": {"<kernel>": {"<batch>": {
         "k_groups": 8, "threads": 128, ...timings...}}}}

Lookup picks the largest tabulated batch <= the requested batch, else
the smallest entry.  The table is stat'ed at most once a second
(``STAT_INTERVAL_S``): the reference stats it on every consult, which
the small kernels' host path cannot afford.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

DEFAULT_PATH = os.path.join("experiments", "tryage", "tile_table_torch.json")
ENV_VAR = "REPRO_TORCH_TILE_TABLE"
#: a consult stats the table at most this often (seconds): the wrappers
#: consult on every launch, and on some hosts a failed ``os.stat`` (no
#: table) takes longer than a router kernel's whole call
STAT_INTERVAL_S = 1.0

_lock = threading.Lock()
_override_path: str | None = None
# path -> (monotonic time of its last stat, its mtime or None, the parsed
# table or None)
_cache: dict = {}


def set_table_path(path: str | None) -> None:
    """Process-wide table override (``--tile-table``); ``None`` restores
    the env-var/default resolution.  Either way the next consult reads
    the table afresh."""
    global _override_path
    with _lock:
        _override_path = path
        _cache.clear()


def table_path() -> str:
    if _override_path is not None:
        return _override_path
    return os.environ.get(ENV_VAR, DEFAULT_PATH)


def _parse(path: str) -> dict | None:
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return None
    return table if isinstance(table, dict) else None


def load_table(path: str | None = None) -> dict | None:
    """The parsed table, or None when absent/unreadable.  Cached on
    (path, mtime); the mtime is read again at most every
    ``STAT_INTERVAL_S``, so a consult costs a clock read and a dict
    lookup, and a rewritten table is seen within that interval."""
    path = path or table_path()
    now = time.monotonic()
    with _lock:
        hit = _cache.get(path)
    if hit is not None and now - hit[0] < STAT_INTERVAL_S:
        return hit[2]
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    if mtime is None:
        table = None
    elif hit is not None and hit[1] == mtime:
        table = hit[2]
    else:
        table = _parse(path)
    with _lock:
        _cache[path] = (now, mtime, table)
    return table


@functools.cache
def backend_key() -> str:
    """This process's table key: ``cuda:<card name>``, or ``cpu``."""
    import torch
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name()}"
    return "cpu"


def tile_for(kernel: str, batch: int, param: str, default: int,
             backend: str | None = None, path: str | None = None) -> int:
    """The tuned value of ``param`` for ``kernel`` at ``batch`` on this
    card, or ``default`` when the table has nothing to say."""
    table = load_table(path)
    if table is None:
        return default
    entries = table.get(backend or backend_key(), {})
    entries = entries.get(kernel) if isinstance(entries, dict) else None
    if not isinstance(entries, dict) or not entries:
        return default
    batches = sorted(int(b) for b in entries if str(b).isdigit())
    if not batches:
        return default
    at_most = [b for b in batches if b <= int(batch)]
    pick = at_most[-1] if at_most else batches[0]
    entry = entries[str(pick)]
    val = entry.get(param) if isinstance(entry, dict) else None
    return int(val) if isinstance(val, (int, float)) else default
