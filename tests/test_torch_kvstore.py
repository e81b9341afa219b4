"""The port's persistent cache store (``repro_torch.serving.kvstore``)
against the JAX package's (``repro.serving.kvstore``).

One T2 directory must serve engines of both packages, so the two stores
are held to each other byte for byte, not only to the crash contract:

* the same operation sequences (overwrites, deletes, deletes of missing
  keys, automatic and explicit compaction) leave byte-identical
  directories: the log, and nothing else;
* recovery agrees after a truncation at every byte offset, after one
  corrupt byte at every offset, and after a fault injected at every
  offset of an append: the same live entries, the same
  ``quarantined_bytes``, the same quarantine file and the same
  truncated log;
* a log written by either package is read back by the other, which
  appends to it and hands it back;
* ``MemoryKVStore`` answers alike.

Exact throughout: bytes and dicts, no tolerance.
"""

import os

import numpy as np
import pytest

from repro_torch.serving import kvstore as tkv

pytest.importorskip("jax")

from repro.serving import kvstore as jkv  # noqa: E402

PACKAGES = {"jax": jkv, "port": tkv}


def _ops(seed, n=40):
    """Random set / delete traffic over a few keys, values of varied
    length: deletes of live keys (tombstones) and of missing keys (no
    record)."""
    rng = np.random.default_rng(seed)
    ops, live = [], set()
    for i in range(n):
        k = b"k%d" % rng.integers(0, 6)
        u = rng.random()
        if u < 0.25 and live:
            k = sorted(live)[rng.integers(0, len(live))]
            ops.append(("del", k, b""))
            live.discard(k)
        elif u < 0.3:
            ops.append(("del", b"missing", b""))
        else:
            ops.append(("set", k, bytes(rng.integers(0, 256,
                                                     rng.integers(0, 48),
                                                     dtype=np.uint8))))
            live.add(k)
    return ops


def _apply(store, ops):
    for op, k, v in ops:
        if op == "set":
            store.set(k, v)
        else:
            store.delete(k)


def _contents(store):
    return {k: store.get(k) for k in store.keys()}


def _dir_state(d):
    """Every file of a store directory, name -> bytes."""
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def _write_log(tmp_path, ops, mod=jkv):
    d = tmp_path / "writer"
    s = mod.DiskKVStore(str(d))
    _apply(s, ops)
    s.close()
    return (d / "segments.log").read_bytes()


def _recover_both(tmp_path, tag, log):
    """Open a copy of ``log`` with each package; return what each
    recovered and the directory each left behind."""
    out = []
    for name, mod in PACKAGES.items():
        d = tmp_path / f"{tag}-{name}"
        d.mkdir()
        (d / "segments.log").write_bytes(log)
        r = mod.DiskKVStore(str(d))
        out.append((_contents(r), r.quarantined_bytes, r._dead_bytes))
        r.close()
        out[-1] += (_dir_state(str(d)),)
    return out


@pytest.mark.parametrize("seed,compact_ratio", [(0, 0.5), (1, 0.5),
                                                (2, 0.01), (3, 0.01)])
def test_same_ops_write_identical_logs(tmp_path, seed, compact_ratio):
    ops = _ops(seed)
    stores = {name: mod.DiskKVStore(str(tmp_path / name),
                                    compact_ratio=compact_ratio)
              for name, mod in PACKAGES.items()}
    for i, op in enumerate(ops):
        for s in stores.values():
            _apply(s, [op])
            s.flush()
        if i == len(ops) // 2:
            for s in stores.values():
                s.compact()
        a, b = (stores[n] for n in PACKAGES)
        assert _contents(b) == _contents(a), i
        assert b._dead_bytes == a._dead_bytes, i
        assert _dir_state(b.dir) == _dir_state(a.dir), i
    for s in stores.values():
        s.close()
    assert len(_dir_state(str(tmp_path / "port"))["segments.log"]) > 0


def test_truncation_at_every_byte_recovers_alike(tmp_path):
    log = _write_log(tmp_path, _ops(5, n=12))
    assert len(log) > 100
    for cut in range(len(log) + 1):
        ref, got = _recover_both(tmp_path, f"cut{cut}", log[:cut])
        assert got == ref, cut


def test_corrupt_byte_at_every_offset_recovers_alike(tmp_path):
    log = _write_log(tmp_path, _ops(5, n=8))
    for at in range(len(log)):
        bad = bytearray(log)
        bad[at] ^= 0xFF
        ref, got = _recover_both(tmp_path, f"flip{at}", bytes(bad))
        assert got == ref, at
        assert got[1] > 0, at             # a flipped byte never replays


def test_fault_injection_at_every_offset_alike(tmp_path):
    base = _ops(6, n=10)
    key, value = b"crashkey", b"crashvalue" * 3
    rec_len = len(jkv._frame(0, key, value))
    assert rec_len == len(tkv._frame(0, key, value))
    for cut in range(rec_len + 1):
        states = []
        for name, mod in PACKAGES.items():
            d = str(tmp_path / f"crash{cut}-{name}")
            s = mod.DiskKVStore(d)
            _apply(s, base)
            s.flush()
            s.fail_after_bytes = cut
            with pytest.raises(mod.SimulatedCrash):
                s.set(key, value)
            s._fh.close()                 # the process is gone
            torn = _dir_state(d)
            r = mod.DiskKVStore(d)
            states.append((torn, _contents(r), r.quarantined_bytes,
                           _dir_state(d)))
            r.close()
        assert states[1] == states[0], cut
        assert states[0][2] == (cut if cut < rec_len else 0), cut


def test_compaction_alike(tmp_path):
    stores = [mod.DiskKVStore(str(tmp_path / name), compact_ratio=0.01)
              for name, mod in PACKAGES.items()]
    for s in stores:
        for i in range(200):              # heavy overwrite churn
            s.set(b"hot", b"v%d" % i)
            s.set(b"k%d" % (i % 8), b"w%d" % i)
            if i % 50 == 49:
                s.delete(b"k%d" % (i % 8))
        s.compact()
        s.close()
    ref, got = (_dir_state(s.dir) for s in stores)
    assert got == ref and list(got) == ["segments.log"]
    for s, mod in zip(stores, PACKAGES.values()):
        r = mod.DiskKVStore(s.dir)
        assert r._dead_bytes == 0 and r.quarantined_bytes == 0
        r.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_log_of_one_package_is_read_by_the_other(tmp_path, writer,
                                                   reader):
    ops = _ops(7)
    d = str(tmp_path / "shared")
    w = PACKAGES[writer].DiskKVStore(d)
    _apply(w, ops)
    want = _contents(w)
    w.close()
    r = PACKAGES[reader].DiskKVStore(d)
    assert _contents(r) == want and r.quarantined_bytes == 0
    r.set(b"from-" + reader.encode(), b"hello")
    r.delete(next(iter(want)))
    after = _contents(r)
    r.close()
    back = PACKAGES[writer].DiskKVStore(d)
    assert _contents(back) == after and back.quarantined_bytes == 0
    back.close()


def test_memory_store_alike():
    stores = [mod.MemoryKVStore() for mod in PACKAGES.values()]
    for s in stores:
        _apply(s, _ops(8))
        s.flush()
        s.close()
    ref, got = stores
    assert got.keys() == ref.keys() and len(got) == len(ref)
    assert _contents(got) == _contents(ref)
