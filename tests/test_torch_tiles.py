"""The port's launch-config table (``repro_torch.kernels.tiles``) and
autotuner (``repro_torch.launch.autotune``) against the JAX package's
``repro.kernels.tiles`` and ``repro.launch.autotune``.

* ``tile_for`` gives the reference's answer on the same table files
  (the largest tabulated batch at or below the request, else the
  smallest; another backend's entries never read; the default for a
  missing, unreadable or malformed table), and never raises, on tables
  where the reference raises too;
* the wrappers' plans (``decision_plan``, ``forward_plan``,
  ``forward_chunk``) take a valid entry, fall back to the default on
  one the kernel cannot take, and leave an explicit argument alone; with
  no table they give the geometry the kernels launched before the table
  existed; the mLSTM backward takes the forward's chunk;
* the engine's ``router_tiles`` record the table's geometry;
* ``autotune(measure=False)`` (no card) records each kernel's default
  geometry, with ``modeled_s`` its roofline bound under the h100
  preset, in the schema the wrappers read; ``write_table`` and
  ``merge_table`` behave as the reference's; measuring without a card
  raises; ``main`` writes and merges a table.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import tiles
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops
from repro_torch.launch import autotune as at
from repro_torch.launch.roofline import PRESETS
from torch_threads import one_torch_thread  # noqa: F401

pytest.importorskip("jax")

from repro.kernels import tiles as jtiles  # noqa: E402
from repro.launch import autotune as jat  # noqa: E402


@pytest.fixture
def table(tmp_path, monkeypatch):
    """Write a table for this process's key and point the wrappers at
    it; restored after."""
    monkeypatch.delenv(tiles.ENV_VAR, raising=False)
    path = tmp_path / "table.json"

    def write(entries):
        path.write_text(json.dumps({"version": 1,
                                    tiles.backend_key(): entries}))
        tiles.set_table_path(str(path))
    yield write
    tiles.set_table_path(None)


TABLES = {
    "good": {"version": 1,
             "cpu": {"k": {"4": {"p": 8}, "16": {"p": 32},
                           "64": {"p": 64.0}}},
             "cuda:NVIDIA H100 80GB HBM3": {"k": {"1": {"p": 2}}}},
    "no_backend": {"version": 1, "gpu": {"k": {"1": {"p": 2}}}},
    "no_kernel": {"cpu": {"other": {"1": {"p": 2}}}},
    "empty_kernel": {"cpu": {"k": {}}},
    "non_digit": {"cpu": {"k": {"x": {"p": 3}, "2a": {"p": 4}}}},
    "bad_value": {"cpu": {"k": {"1": {"p": "big"}, "8": {"q": 1}}}},
    "entry_not_dict": {"cpu": {"k": {"1": 5}}},
    "not_a_dict": [1, 2, 3],
}


@pytest.mark.parametrize("name", list(TABLES))
def test_tile_for_matches_reference(tmp_path, name):
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(TABLES[name], f)
    for backend in ("cpu", "gpu", "tpu", "cuda:NVIDIA H100 80GB HBM3"):
        for batch in (0, 1, 3, 4, 5, 16, 63, 64, 10_000):
            want = jtiles.tile_for("k", batch, "p", -1, backend=backend,
                                   path=path)
            got = tiles.tile_for("k", batch, "p", -1, backend=backend,
                                 path=path)
            assert got == want, (backend, batch)


def test_tile_for_never_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tiles, "STAT_INTERVAL_S", 0.0)   # re-read each time
    path = tmp_path / "t.json"
    for text in ("{not json", json.dumps({"cpu": 5}),
                 json.dumps({"cpu": {"k": [1, 2]}}), ""):
        path.write_text(text)
        assert tiles.tile_for("k", 8, "p", 7, backend="cpu",
                              path=str(path)) == 7
    assert tiles.tile_for("k", 8, "p", 7, path=str(tmp_path / "none")) == 7


def test_table_path_resolution(monkeypatch):
    monkeypatch.delenv(tiles.ENV_VAR, raising=False)
    tiles.set_table_path(None)
    assert tiles.table_path() == tiles.DEFAULT_PATH
    assert tiles.DEFAULT_PATH != jtiles.DEFAULT_PATH
    monkeypatch.setenv(tiles.ENV_VAR, "/x/env.json")
    assert tiles.table_path() == "/x/env.json"
    tiles.set_table_path("/x/flag.json")
    try:
        assert tiles.table_path() == "/x/flag.json"
    finally:
        tiles.set_table_path(None)
    assert tiles.backend_key() == ("cpu" if not torch.cuda.is_available()
                                   else f"cuda:{torch.cuda.get_device_name()}")


def test_load_table_is_cached_on_mtime(tmp_path, monkeypatch):
    monkeypatch.setattr(tiles, "STAT_INTERVAL_S", 0.0)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"cpu": {"k": {"1": {"p": 2}}}}))
    a = tiles.load_table(str(path))
    assert tiles.load_table(str(path)) is a
    path.write_text(json.dumps({"cpu": {"k": {"1": {"p": 3}}}}))
    os.utime(path, ns=(1, 10**18))
    assert tiles.load_table(str(path))["cpu"]["k"]["1"]["p"] == 3
    path.unlink()
    assert tiles.load_table(str(path)) is None


def test_consults_stat_at_most_once_an_interval(tmp_path, monkeypatch):
    """Within ``STAT_INTERVAL_S`` a consult reads no file system (a
    missing table included); after it, the table is read again, and
    ``set_table_path`` forgets at once."""
    stats = []
    real = os.stat
    monkeypatch.setattr(tiles.os, "stat",
                        lambda p, *a, **k: stats.append(p) or real(p, *a,
                                                                   **k))
    clock = [100.0]
    monkeypatch.setattr(tiles.time, "monotonic", lambda: clock[0])
    path = str(tmp_path / "t.json")
    tiles.set_table_path(path)
    try:
        for _ in range(50):
            assert tiles.tile_for("k", 4, "p", 7) == 7
        assert stats == [path]
        with open(path, "w") as f:
            json.dump({tiles.backend_key(): {"k": {"1": {"p": 2}}}}, f)
        assert tiles.tile_for("k", 4, "p", 7) == 7        # not yet seen
        clock[0] += tiles.STAT_INTERVAL_S
        assert tiles.tile_for("k", 4, "p", 7) == 2
        assert len(stats) == 2
        tiles.set_table_path(path)
        assert tiles.tile_for("k", 4, "p", 7) == 2 and len(stats) == 3
    finally:
        tiles.set_table_path(None)


# -------------------------------------------------------------- plans

# the geometry each kernel launched before the table (the parent's
# plans, written out): router k-groups and threads, attention warps,
# the mLSTM chunk
def _old_router_plan(B, d, hh, heads):
    per_block = -(-hh // 8)
    units = heads * per_block
    groups = 1
    while 2 * groups * units <= 256 and 2 * groups <= d:
        groups *= 2
    return {"grid": 8 * B, "cluster": 8, "units_per_block": per_block,
            "threads": min(256, -(-groups * units // 32) * 32),
            "k_groups": groups}


@pytest.mark.parametrize("B,d,hh", [(1, 128, 128), (32, 128, 128),
                                    (3, 16, 8), (8, 32, 128), (5, 2, 40)])
def test_plans_without_a_table_are_the_old_geometry(B, d, hh, monkeypatch):
    monkeypatch.delenv(tiles.ENV_VAR, raising=False)
    tiles.set_table_path(None)
    assert rs_ops.decision_plan(B, d, hh) == _old_router_plan(B, d, hh, 1)
    assert rc_ops.decision_plan(B, d, hh) == _old_router_plan(B, d, hh, 2)
    for S, H, hd in ((128, 4, 32), (512, 32, 64), (16, 1, 256)):
        assert fa_ops.forward_plan(B, S, H, hd)["launch_warps"] == 0
    for S in (64, 96, 97, 512):
        assert ml_ops.forward_chunk(B, S) == ml_ops.pick_chunk(S, 64)


def test_router_plans_honour_the_table(table):
    table({"router_score": {"1": {"k_groups": 2}, "16": {"k_groups": 64}},
           "router_cascade": {"4": {"k_groups": 1}}})
    assert rs_ops.decision_plan(1, 128, 128)["k_groups"] == 2
    assert rs_ops.decision_plan(8, 128, 128)["k_groups"] == 2
    plan = rs_ops.decision_plan(32, 128, 128)
    assert plan["k_groups"] == 64 and plan["threads"] == 256
    assert rc_ops.decision_plan(1, 128, 128)["k_groups"] == 1
    assert rc_ops.decision_plan(4, 128, 128)["threads"] == 32
    # an explicit geometry is never second-guessed
    assert rs_ops.decision_plan(1, 128, 128, k_groups=16)["k_groups"] == 16
    with pytest.raises(ValueError, match="k_groups"):
        rs_ops.decision_plan(1, 128, 128, k_groups=3)


@pytest.mark.parametrize("bad", [0, 3, 256, -4, 512])
def test_router_plans_reject_invalid_entries(table, bad):
    table({"router_score": {"1": {"k_groups": bad}}})
    assert rs_ops.decision_plan(4, 128, 128) == _old_router_plan(
        4, 128, 128, 1)


@pytest.mark.parametrize("entry,want", [(1, 1), (2, 2), (4, 4), (3, 0),
                                        (8, 0), (0, 0)])
def test_attention_plan_honours_the_table(table, entry, want):
    table({"flash_attention": {"1": {"warps": entry}}})
    plan = fa_ops.forward_plan(8, 128, 4, 32)
    assert plan["launch_warps"] == want
    assert plan["warps"] == (want or fa_ops.default_warps(8, 128, 4, 32))
    assert plan["grid"][0] == math.ceil(128 / (16 * plan["warps"]))
    assert fa_ops.forward_plan(8, 128, 4, 32, warps=2)["launch_warps"] == 2
    with pytest.raises(ValueError, match="warps"):
        fa_ops.forward_plan(8, 128, 4, 32, warps=3)


@pytest.mark.parametrize("entry,S,want", [(32, 128, 32), (16, 64, 16),
                                          (48, 64, 64), (128, 256, 64),
                                          (0, 64, 64), (7, 96, 48)])
def test_mlstm_chunk_honours_the_table(table, entry, S, want):
    table({"mlstm_scan": {"2": {"chunk": entry}}})
    assert ml_ops.forward_chunk(2, S) == want
    assert ml_ops.forward_chunk(2, S, chunk=8) == 8
    with pytest.raises(ValueError, match="chunk"):
        ml_ops.forward_chunk(2, S, chunk=S + 1)


def test_mlstm_runs_and_differentiates_at_the_table_chunk(table):
    """On the CPU the plain version runs at the table's chunk, and the
    gradient is taken through the same chunk (the backward takes the
    forward's)."""
    table({"mlstm_scan": {"1": {"chunk": 16}}})
    rng = np.random.default_rng(0)
    B, S, H, dh = 1, 64, 2, 8
    f = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    q, k, v, i, fg = f(B, S, H, dh), f(B, S, H, dh), f(B, S, H, dh), \
        f(B, S, H), f(B, S, H) + 3.0
    st = {"C": torch.zeros(B, H, dh, dh), "n": torch.zeros(B, H, dh),
          "m": torch.zeros(B, H)}
    h, out = ml_ops.mlstm_chunkwise(q, k, v, i, fg, st)
    rh, rout = ml_ops.mlstm_chunkwise_plain(q, k, v, i, fg, st, chunk=16)
    assert torch.equal(h, rh) and torch.equal(out["C"], rout["C"])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, i, fg)]
    h, _ = ml_ops.mlstm_chunkwise(*leaves, st)
    dh_ = f(B, S, H, dh)
    got = torch.autograd.grad(h, leaves, dh_)
    want = ml_ops.mlstm_chunkwise_grad_plain(q, k, v, i, fg, st, dh_,
                                             chunk=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ml_ops.backward_chunk(512, 64, 16) == 16
    assert ml_ops.backward_chunk(512, 64) == 64


def test_engine_records_the_table_geometry(table, tiny_library):
    from torch_serving_util import make_weights
    from repro_torch.core import objective as tobj
    from repro_torch.serving import Request, TryageEngine
    from test_torch_engine import _workload
    table({"router_score": {"1": {"k_groups": 4}, "8": {"k_groups": 32}}})
    _, router, rc, lib = make_weights(tiny_library)
    eng = TryageEngine(lib, router, rc, [tobj.size_constraint(lib)],
                       max_batch=8, device="cpu")
    for w in _workload(n=20):
        eng.submit(Request(**w))
    eng.run()
    plans = eng.stats.router_tiles["router_score"]
    assert plans
    d, hh = router.head["w1"].shape
    for Bp, plan in plans.items():
        assert plan["k_groups"] == (32 if Bp >= 8 else 4)
        assert plan == rs_ops.decision_plan(Bp, d, hh)


# ----------------------------------------------------------- autotune

@pytest.fixture(scope="module")
def modeled():
    """One sweep without a card: the defaults and their bounds."""
    tiles.set_table_path(None)
    return at.autotune(measure=False)


def test_autotune_no_measure_records_the_defaults(modeled):
    assert modeled["version"] == 1
    entries = modeled[tiles.backend_key()]
    assert set(entries) == set(at.KERNELS)
    for name, (_, batches, _) in at.KERNELS.items():
        assert sorted(map(int, entries[name])) == sorted(batches)
    d, hh = at.ROUTER["d"], at.ROUTER["hh"]
    for b, e in entries["router_score"].items():
        assert {k: e[k] for k in ("k_groups", "threads")} == {
            k: rs_ops.decision_plan(int(b), d, hh)[k]
            for k in ("k_groups", "threads")}
        assert e["measured_s"] is None and e["candidates_s"] is None
        flops, nbytes = rs_ops.head_cost(int(b), d, hh, at.ROUTER["M"],
                                         at.ROUTER["n_c"], False)
        assert e["modeled_s"] == pytest.approx(max(
            flops / PRESETS["h100"].peak_flops,
            nbytes / PRESETS["h100"].hbm_bw))
        assert e["default"]["k_groups"] == e["k_groups"]
    for b, e in entries["router_cascade"].items():
        assert e["k_groups"] == rc_ops.decision_plan(int(b), d, hh)[
            "k_groups"]
    S, H, hd = (at.ATTENTION[k] for k in ("S", "H", "hd"))
    for b, e in entries["flash_attention"].items():
        assert e["warps"] == fa_ops.default_warps(int(b), S, H, hd)
        assert e["shape"]["B"] == int(b)
    for b, e in entries["mlstm_scan"].items():
        assert e["chunk"] == ml_ops.pick_chunk(at.MLSTM["S"], 64)


def test_candidates_cover_every_valid_geometry():
    rng = np.random.default_rng(0)
    work = at._router_candidates(4, rng)
    assert [c.params["k_groups"] for c in work.candidates] == [
        1, 2, 4, 8, 16, 32, 64, 128]
    for c in work.candidates:
        assert c.record["threads"] == rs_ops.decision_plan(
            4, 128, 128, k_groups=c.params["k_groups"])["threads"]
    assert [c.params["warps"] for c in at._flash_candidates(
        8, rng).candidates] == [1, 2, 4]
    assert [c.params["chunk"] for c in at._mlstm_candidates(
        4, rng).candidates] == [16, 32, 64]


def test_measuring_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        at.autotune(kernels=["router_score"], measure=True)


def test_write_and_merge_match_reference(tmp_path, modeled):
    path = str(tmp_path / "t.json")
    old = {"version": 1, "cpu": {"router_score": {"1": {"k_groups": 2}},
                                 "other": {"2": {"x": 1}}},
           "cuda:another card": {"mlstm_scan": {"4": {"chunk": 16}}}}
    at.write_table(old, path)
    jpath = str(tmp_path / "j.json")
    jat.write_table(old, jpath)
    assert open(path).read() == open(jpath).read()
    merged = at.merge_table(modeled, path)
    assert merged == jat.merge_table(modeled, jpath)
    assert merged["cuda:another card"] == old["cuda:another card"]
    assert merged["cpu"]["other"] == old["cpu"]["other"]
    assert at.merge_table(modeled, str(tmp_path / "none.json")) is modeled


def test_main_writes_and_merges(tmp_path):
    path = str(tmp_path / "t.json")
    at.main(["--no-measure", "--out", path, "--kernels", "router_score",
             "--batches", "1,8"])
    at.main(["--no-measure", "--out", path, "--kernels", "mlstm_scan",
             "--fast"])
    with open(path) as f:
        t = json.load(f)
    assert set(t[tiles.backend_key()]) == {"router_score", "mlstm_scan"}
    assert set(t[tiles.backend_key()]["router_score"]) == {"1", "8"}
    with pytest.raises(SystemExit):
        at.main(["--no-measure", "--out", path, "--kernels", "nope"])
