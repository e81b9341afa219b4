"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name
in it finds its files; the harness refuses to run without a card and
never loads JAX or the JAX package."""

import json
import os
import re
import subprocess
import sys

import pytest

import tiny
from harness import core

SPEC = tiny.SPEC
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in SPEC[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and 1 <= len(e["why"]) <= 200
    for e in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        assert e["name"] not in names
        names.add(e["name"])
    for e in SPEC["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in SPEC["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_finds_its_files_and_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    used = set()
    for w in SPEC["workloads"]:
        assert w["chips"] == 1
        cell = core.Cell(SPEC, w["name"])
        used.add(w["config"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e and m["moves"] in reported
            reader = core.load_file(core.BENCH / "metrics" / f"{m['name']}.py")
            assert callable(reader.read)
        assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("bench/configs/")
        assert os.path.exists(core.ROOT / c["file"])
        assert len(c["reduced"]) <= 16


def _bench(*args, env=None, timeout=120):
    return subprocess.run([sys.executable, str(core.BENCH / "run.py"), *args],
                          capture_output=True, text=True, cwd=core.ROOT,
                          env=env, timeout=timeout)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _bench("--workload", SPEC["workloads"][0]["name"], "--seed",
               "3000000000", "--seconds", "1", "--trace", "0", env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


PROBE = """
import sys, time
sys.argv = ["run.py"]
sys.path[:0] = [{bench!r}, {src!r}]
import tiny
import run
from harness import core
for w in tiny.SPEC["workloads"]:
    cell = tiny.cell(w["name"])
    for m in cell.per_layer:
        core.load_file(core.BENCH / "metrics" / (m["name"] + ".py"))
    core.run_cell(cell, 3, 0.3, w["name"].startswith("sc2-prefill"), "cpu",
                  time.monotonic())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(core.forbidden_modules())
"""


def test_nothing_it_loads_is_jax_or_the_jax_package():
    code = PROBE.format(bench=str(core.BENCH / "tests"),
                        src=str(core.ROOT / "src"))
    env = dict(os.environ, USE_FLAX="0")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=core.ROOT, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded, forbidden = p.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert "'repro_torch'" in loaded
    for name in ("jax", "jaxlib", "flax", "repro"):
        assert f"'{name}'" not in loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert core.forbidden_modules() == ["repro"]


@pytest.mark.gpu
def test_each_cell_runs_on_the_card():
    """One short run of every cell on the card (skips without one)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w in SPEC["workloads"]:
        p = _bench("--workload", w["name"], "--seed", "4000000001",
                   "--seconds", "3", "--trace", "0", timeout=1200)
        assert p.returncode == 0, p.stderr[-3000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"], out["checks"]
