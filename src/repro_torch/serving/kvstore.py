"""Valkey/Redis-shaped KV interface with a crash-safe disk default.

The decision-cache stack's persistent tier (T2) talks to a deliberately
tiny key/value surface — ``get``/``set``/``delete``/``keys``/``flush``/
``close`` over ``bytes`` keys and values — so swapping the disk-backed
default for a real Valkey/Redis client is a one-class adapter, and
tests can substitute ``MemoryKVStore`` for hermetic runs (two engine
replicas sharing one ``MemoryKVStore`` share verdicts the same way two
processes share a Valkey instance).

``DiskKVStore`` is the restart-safe default: an append-only segment log
of crc32-checked records.  Every ``set``/``delete`` appends one framed
record; an in-memory index maps live keys to their latest value, so
reads never touch disk.  Recovery replays the log from byte 0 and stops
at the first torn or corrupt record: the intact prefix is the store, the
tail is *quarantined* to a sidecar file (never served, never fatal) and
the log is truncated back to the last good boundary — killing the
process at any byte offset loses at most the record being written.
Compaction rewrites the live index into a fresh log and publishes it
with an atomic ``os.replace`` (readers of the old path see either the
old complete log or the new complete log, nothing in between).

Fault injection for the crash-safety tests: set ``fail_after_bytes`` and
the next append writes exactly that many bytes of the record before
raising ``SimulatedCrash`` — the torn-tail shape a real ``kill -9``
leaves behind.

A copy of ``repro.serving.kvstore`` (pure Python): for the same
operations both packages write byte-identical logs, so one directory
serves a JAX engine and a port engine alike
(``tests/test_torch_kvstore.py`` holds the two against each other).
"""

from __future__ import annotations

import os
import struct
import zlib

# record framing: MAGIC | op | key-len | value-len | crc32(op+lens+key+value)
_MAGIC = 0xA7
_OP_SET = 0
_OP_DEL = 1
_HEADER = struct.Struct("<BBIII")


class SimulatedCrash(RuntimeError):
    """Raised by the fault-injection hook mid-append (test-only)."""


class KVStore:
    """The Valkey-shaped contract T2 is written against (duck-typed;
    subclassing is optional)."""

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def keys(self) -> list[bytes]:
        raise NotImplementedError

    def flush(self) -> None:
        """Durability point (no-op for volatile implementations)."""

    def close(self) -> None:
        pass

    def __len__(self) -> int:
        return len(self.keys())


class MemoryKVStore(KVStore):
    """Volatile dict-backed store — the hermetic test double, and the
    cheapest way to share one T2 between in-process engine replicas."""

    def __init__(self):
        self._d: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> bytes | None:
        return self._d.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        self._d[bytes(key)] = bytes(value)

    def delete(self, key: bytes) -> None:
        self._d.pop(key, None)

    def keys(self) -> list[bytes]:
        return list(self._d)

    def __len__(self) -> int:
        return len(self._d)


def _frame(op: int, key: bytes, value: bytes) -> bytes:
    crc = zlib.crc32(bytes([op]))
    crc = zlib.crc32(struct.pack("<II", len(key), len(value)), crc)
    crc = zlib.crc32(key, crc)
    crc = zlib.crc32(value, crc)
    return _HEADER.pack(_MAGIC, op, len(key), len(value), crc) + key + value


def _scan(buf: bytes):
    """Yield ``(op, key, value, end_offset)`` for every intact record in
    ``buf``; stop (without raising) at the first torn/corrupt one."""
    off, n = 0, len(buf)
    while off + _HEADER.size <= n:
        magic, op, klen, vlen, crc = _HEADER.unpack_from(buf, off)
        end = off + _HEADER.size + klen + vlen
        if magic != _MAGIC or op not in (_OP_SET, _OP_DEL) or end > n:
            return
        key = buf[off + _HEADER.size:off + _HEADER.size + klen]
        value = buf[off + _HEADER.size + klen:end]
        want = zlib.crc32(bytes([op]))
        want = zlib.crc32(struct.pack("<II", klen, vlen), want)
        want = zlib.crc32(key, want)
        want = zlib.crc32(value, want)
        if want != crc:
            return
        yield op, key, value, end
        off = end


class DiskKVStore(KVStore):
    """Append-only segment log with crc32 records and atomic-rename
    compaction; see the module docstring for the recovery contract.

    ``compact_ratio``: auto-compact once dead (overwritten/deleted)
    bytes exceed this fraction of the log.  ``fsync``: fsync on every
    ``flush()`` (appends are buffered either way; callers that need a
    durability point call ``flush``).
    """

    def __init__(self, directory: str, compact_ratio: float = 0.5,
                 fsync: bool = False):
        self.dir = directory
        self.path = os.path.join(directory, "segments.log")
        self._fsync = fsync
        self._compact_ratio = compact_ratio
        self._index: dict[bytes, bytes] = {}
        self._dead_bytes = 0
        self.quarantined_bytes = 0          # torn-tail bytes set aside
        self.fail_after_bytes: int | None = None   # fault-injection hook
        os.makedirs(directory, exist_ok=True)
        self._recover()
        self._fh = open(self.path, "ab")

    # ------------------------------------------------------- recovery

    def _recover(self) -> None:
        if not os.path.exists(self.path):
            with open(self.path, "wb"):
                pass
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        good = 0
        for op, key, value, end in _scan(buf):
            if key in self._index:
                self._dead_bytes += _HEADER.size + len(key) + \
                    len(self._index[key])
            if op == _OP_SET:
                self._index[key] = value
            else:
                self._index.pop(key, None)
                self._dead_bytes += end - good   # tombstone is dead weight
            good = end
        if good < len(buf):
            # torn or corrupt tail: quarantine it (diagnosable, never
            # served) and truncate the log to the last intact boundary
            tail = buf[good:]
            self.quarantined_bytes = len(tail)
            qpath = os.path.join(self.dir, f"quarantine-{good}.bin")
            with open(qpath, "wb") as q:
                q.write(tail)
            with open(self.path, "r+b") as f:
                f.truncate(good)

    # ------------------------------------------------------------- api

    def get(self, key: bytes) -> bytes | None:
        return self._index.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        key, value = bytes(key), bytes(value)
        old = self._index.get(key)
        self._append(_frame(_OP_SET, key, value))
        if old is not None:
            self._dead_bytes += _HEADER.size + len(key) + len(old)
        self._index[key] = value
        self._maybe_compact()

    def delete(self, key: bytes) -> None:
        if key not in self._index:
            return
        rec = _frame(_OP_DEL, bytes(key), b"")
        self._append(rec)
        self._dead_bytes += _HEADER.size + len(key) + \
            len(self._index.pop(key)) + len(rec)
        self._maybe_compact()

    def keys(self) -> list[bytes]:
        return list(self._index)

    def __len__(self) -> int:
        return len(self._index)

    def flush(self) -> None:
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        self.flush()
        self._fh.close()

    # ------------------------------------------------------- internals

    def _append(self, rec: bytes) -> None:
        if self.fail_after_bytes is not None:
            cut = min(self.fail_after_bytes, len(rec))
            self._fh.write(rec[:cut])
            self._fh.flush()
            raise SimulatedCrash(f"fault injection: wrote {cut}/"
                                 f"{len(rec)} bytes")
        self._fh.write(rec)

    def _maybe_compact(self) -> None:
        live = sum(_HEADER.size + len(k) + len(v)
                   for k, v in self._index.items())
        if self._dead_bytes > 256 and \
                self._dead_bytes > self._compact_ratio * (live + 1):
            self.compact()

    def compact(self) -> None:
        """Rewrite the live index into a fresh log and publish it with
        an atomic rename — a crash mid-compaction leaves the old log
        untouched."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for k, v in self._index.items():
                f.write(_frame(_OP_SET, k, v))
            f.flush()
            os.fsync(f.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")
        self._dead_bytes = 0
