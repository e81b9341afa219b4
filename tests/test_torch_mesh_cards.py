"""``scripts/mesh_serve_cards.py`` in its ``--cpu`` mode: the serving mesh
cases over repeated CPU slots on the script's tiny seeded library, with
one timed run each.  It checks the script, not the numbers: every case
holds, and its JSON carries the streams and the decision and launch
checks that the run on the cards reads."""

import importlib.util
import json
from pathlib import Path

import pytest

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("1x2", "2x1", "2x2", "1x4")


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "mesh_serve_cards", ROOT / "scripts" / "mesh_serve_cards.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = tmp_path_factory.mktemp("mesh_cards") / "report.json"
    rc = script.main(["--cpu", "--repeats", "1", "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_every_case_holds(report):
    rc, rep = report
    failed = [c.get("mesh", c.get("argv")) for c in
              [rep["kernels"]] + rep["meshes"] + rep["cli"] if not c["ok"]]
    assert rc == 0 and rep["ok"] and not failed, failed
    assert rep["card"] == "cpu"
    assert [m["mesh"] for m in rep["meshes"]] == list(MESHES)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_case_reports_streams_and_decisions(report, mesh):
    _, rep = report
    case = next(m for m in rep["meshes"] if m["mesh"] == mesh)
    data, model = (int(x) for x in mesh.split("x"))
    assert len(case["devices"]) == data * model
    for part in ("serve", "run"):
        got = case[part]
        streams = got["streams"]
        assert streams["streams"] == data * model
        assert sum(streams["flushes"]) > 0
        if model > 1:
            assert sum(f > 0 for f in streams["flushes"]) > 1
        calls = got["decision_calls"]
        scored = got["router_batches"] - sum(
            calls["router_cascade"].values())
        assert sum(calls["router_score"].values()) == data * scored
        assert (sum(calls["router_cascade"].values()) == 0) == (data > 1)
        assert set(got["launches"]) >= {"router_score", "router_cascade",
                                         "flash_attention"}
        assert got["near_tie_excused"] >= 0
        assert got["nll_max_rel_diff"] <= 1e-5
    fails = case["failures"]
    assert fails["expert_failures"] > 0 and fails["reroutes"] > 0
    assert ("adapt" in case) == (data > 1)
    tput = case["throughput"]
    assert set(tput["req_per_s"]) == {f"{c}/{d}" for c in
                                      ("meshless", "1x1", "mesh")
                                      for d in ("run", "serve")}
    assert tput["makespan_speedup_over_1x1"] > 0


def test_kernels_and_cli_cases(report):
    _, rep = report
    kernels = rep["kernels"]
    names = [c["case"].split()[0] for c in kernels["cases"]]
    assert names == ["router_score", "router_cascade", "flash_attention",
                     "flash_attention"]
    assert all(all(c["bitwise_as_first"].values()) for c in kernels["cases"])
    assert kernels["router_score_call_us"]["cpu"]["host_us"] > 0
    # one CPU device backs no mesh of four: the CLI keeps the count error
    for case in rep["cli"]:
        assert "needs 4 devices but only 1 is visible" in case["count_error"]


def test_mesh_gate_case(report):
    """The mesh gate over four CPU slots: sizes 1, 2 and 4 run, size 8 is
    skipped with its reason, choices agree across sizes, and each size
    reports its simulated and wall tokens/s over every served token."""
    _, rep = report
    gate = rep["gate_mesh"]
    assert gate["ok"] and gate["devices"] == ["cpu"] * 4
    rows = {name: (value, derived) for name, value, derived in gate["rows"]}
    assert rows["mesh/size8_skipped"] == (1.0, "needs 8 devices, have 4")
    assert rows["mesh/choice_match"][0] == 1.0
    assert [s["mesh_size"] for s in gate["sizes"]] == [1, 2, 4]
    for size in gate["sizes"]:
        assert size["tokens"] == sum(size["stream_tokens"]) == 256 * 64
        assert size["makespan_s"] == max(size["busy_s"])
        assert size["simulated_tokens_per_s"] > 0
        assert size["wall_tokens_per_s"] > 0
