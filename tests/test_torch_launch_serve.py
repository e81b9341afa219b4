"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``).

* ``poisson_arrivals`` on a fake clock yields the same sequence of
  requests and idle ticks, with the same arrival stamps;
* ``parse_priority_mix`` gives the same fractions;
* every ``ap.error`` of the JAX driver fires alike with the same
  message, except the one the port drops on purpose
  (``--fused-cascade`` without ``--use-kernel``: the port always decides
  through its kernels); without a card and without ``--device`` the
  command raises instead of serving on the CPU;
* the mesh flags fail alike: ``--replicate-hot`` without ``--mesh`` and
  a malformed ``--mesh`` with the reference's messages, ``--mesh 2,4
  --device cpu`` with the reference's count error (one CPU device backs
  only ``--mesh 1,1``);
* ``--sanitize`` and ``--tile-table`` are served: the summary matches
  the JAX CLI's (``"sanitize": true``) and the port's kernels consult
  the given table;
* ``main()`` of both packages on the CPU over the same tiny artifacts
  (``tiny_library``, one router with an uncertainty head, a vocab-64
  corpus; ``load_artifacts`` monkeypatched, the port with ``--device
  cpu``) gives the same summary JSON in every field but the wall-clock
  ones (``wall_s``, ``req_per_s``, latency percentiles, router, expert
  and adaptation seconds), the port's launch plans (``router_tiles``,
  the CUDA kernels' geometry, not the Pallas tiles) and the port's
  extra ``device``; with ``--mesh 1,1 --replicate-hot 1`` the
  ``"mesh"`` block is the same but for each stream's busy seconds.  ``--max-wait-s 10`` keeps deadlines out of the
  closed-loop runs, so their flushes do not depend on the host's speed.
  Tolerance: mean loss and accuracy (rounded to 4 places by the driver)
  and the adaptation errors (6 places) within 1e-5.
"""

import json
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as tserve
from torch_serving_util import make_weights
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")

from repro.launch import serve as jserve  # noqa: E402

TOL = 1e-5


class FakeClock:
    def __init__(self):
        self.t = 100.0
        self.sleeps = []

    def __call__(self):
        self.t += 1e-4           # every read moves the clock a little
        return self.t

    def sleep(self, dt):
        self.sleeps.append(dt)
        self.t += dt


class Item:
    def __init__(self, uid):
        self.uid = uid
        self.arrival = None


@pytest.mark.parametrize("rate", [0.0, 50.0, 2000.0])
def test_poisson_arrivals_match_jax(rate):
    out = []
    for mod in (jserve, tserve):
        clock = FakeClock()
        items = [Item(i) for i in range(24)]
        seq = [None if x is None else x.uid
               for x in mod.poisson_arrivals(items, rate,
                                             np.random.default_rng(3),
                                             now_fn=clock,
                                             sleep_fn=clock.sleep)]
        out.append((seq, [x.arrival for x in items], clock.sleeps))
    assert out[1] == out[0]
    seq = out[0][0]
    assert [u for u in seq if u is not None] == list(range(24))
    assert (None in seq) == (rate > 0)


@pytest.mark.parametrize("spec", ["0.9,0.08,0.02", "1,1", "", "0,0",
                                  " 3 , 1 ,", "5"])
def test_parse_priority_mix_matches_jax(spec):
    assert tserve.parse_priority_mix(spec) == jserve.parse_priority_mix(spec)


def _jax_main(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    return jserve.main()


ERRORS = [
    ["--adapt-every", "4", "--replay-cap", "0"],
    ["--cache-tiers", "exact,disk"],
    ["--cache-tiers", "persistent"],
    ["--cache-tiers", "semantic"],
    ["--cache-tiers", "semantic", "--cache-semantic", "-1"],
    ["--no-cache", "--cache-tiers", "exact,persistent", "--cache-dir", "x"],
    ["--use-kernel", "--fused-cascade"],
    ["--speculate"],
    ["--speculate", "--cascade", "0.5", "--fallback-depth", "1"],
    ["--speculate", "--cascade", "0.5", "--fail-expert", "big"],
    ["--speculate", "--cascade", "0.5", "--fifo"],
]


@pytest.mark.parametrize("argv", ERRORS, ids=lambda a: " ".join(a))
def test_argument_errors_match_jax(monkeypatch, capsys, argv):
    msgs = []
    for run in (lambda: _jax_main(monkeypatch, argv),
                lambda: tserve.main(argv + ["--device", "cpu"])):
        with pytest.raises(SystemExit) as err:
            run()
        assert err.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[1].split("error: ")[1] == msgs[0].split("error: ")[1]


def test_fused_cascade_needs_only_cascade(monkeypatch, capsys):
    argv = ["--fused-cascade", "--cascade", "0.6"]
    with pytest.raises(SystemExit):
        _jax_main(monkeypatch, argv)
    assert "--fused-cascade needs --use-kernel" in capsys.readouterr().err
    # the port gets past its checks (to the missing card)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(argv)


@pytest.mark.parametrize("argv", [["--replicate-hot", "1"],
                                  ["--mesh", "x"], ["--mesh", "1,2,3"]],
                         ids=" ".join)
def test_mesh_flag_errors_match_jax(monkeypatch, capsys, artifacts, argv):
    """The JAX CLI checks the mesh flags after loading its
    artifacts (monkeypatched here); the port before, with the same
    messages."""
    from repro.core import experiment as jex
    monkeypatch.setattr(jex, "load_artifacts", lambda: artifacts[0])
    msgs = []
    for run in (lambda: _jax_main(monkeypatch, argv),
                lambda: tserve.main(argv + ["--device", "cpu"])):
        with pytest.raises(SystemExit) as err:
            run()
        assert err.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[1].split("error: ")[1] == msgs[0].split("error: ")[1]
    assert msgs[1].endswith(("--replicate-hot needs --mesh",
                             "--mesh expects two integers 'data,model'"))


def test_mesh_beyond_the_devices_raises_the_count_error(monkeypatch,
                                                        artifacts):
    """One CPU device backs only ``--mesh 1,1``: a larger mesh raises
    the reference's count error (its first sentence; the second says
    how each package simulates more devices), on no other device."""
    from repro.core import experiment as jex
    monkeypatch.setattr(jex, "load_artifacts", lambda: artifacts[0])
    msgs = []
    for run in (lambda: _jax_main(monkeypatch, ["--mesh", "2,4"]),
                lambda: tserve.main(["--mesh", "2,4", "--device", "cpu"])):
        with pytest.raises(ValueError, match="needs 8 devices but only 1 "
                                             "is visible") as err:
            run()
        msgs.append(str(err.value))
    assert msgs[1].split(". ")[0] == msgs[0].split(". ")[0]
    assert "devices=" in msgs[1]


def test_serving_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--requests", "4"])


# ---------------------------------------------------- main() against JAX


@pytest.fixture
def switches():
    """The process-wide sanitizer switch and table path that
    ``--sanitize`` and ``--tile-table`` set, restored after."""
    from repro.kernels import sanitize as jsan
    from repro.kernels import tiles as jtiles
    from repro_torch.kernels import sanitize as tsan
    from repro_torch.kernels import tiles as ttiles
    yield
    tsan.set_sanitize(None)
    jsan.set_sanitize(None)
    ttiles.set_table_path(None)
    jtiles.set_table_path(None)


@pytest.fixture(scope="module")
def artifacts(tiny_library):
    from repro.data.corpus import DomainCorpus as JCorpus
    from repro_torch.data.corpus import DomainCorpus as TCorpus
    from test_torch_engine import RC
    rp, router, port_rc, port_lib = make_weights(tiny_library)
    return ({"library": tiny_library, "router_params": rp, "rc": RC,
             "corpus": JCorpus(vocab_size=64, seed=0)},
            {"library": port_lib, "router_params": router, "rc": port_rc,
             "corpus": TCorpus(vocab_size=64, seed=0)})


def _comparable(summary):
    s = json.loads(json.dumps(summary))
    for key in ("wall_s", "req_per_s", "device"):
        s.pop(key, None)
    if s["mesh"] is not None:     # stream busy time is wall time
        for key in ("busy_s", "makespan_s", "total_busy_s"):
            s["mesh"]["streams"].pop(key)
    eng = s["engine"]
    for key in ("router_time_s", "expert_time_s", "latency", "router_tiles"):
        eng.pop(key)
    eng["cascade"].pop("tier_latency")
    eng["adaptation"].pop("time_s")
    floats = {k: s.pop(k) for k in ("mean_mlm_accuracy", "mean_mlm_loss")}
    floats.update({k: eng["adaptation"].pop(k)
                   for k in ("pre_err", "post_err")})
    return s, floats


def _jax_summary(monkeypatch, capsys, argv):
    _jax_main(monkeypatch, argv)
    out = capsys.readouterr().out
    return json.loads(out[out.index("\n{") + 1:] if not out.startswith("{")
                      else out)


MAIN_CASES = {
    "serve": [],
    "fifo_fused_cascade": ["--fifo", "--cascade", "0.6", "--fused-cascade"],
    "sessions_speculate": ["--sessions", "3", "--cascade", "0.6",
                           "--speculate", "--admission-cap", "16"],
    "health_failure": ["--fallback-depth", "2", "--fail-expert", "big",
                       "--fail-after", "40", "--cascade", "0.6"],
    "adapt_drift": ["--adapt-every", "8", "--drift-after", "48",
                    "--drift-domains", "github,pubmed", "--no-buckets"],
    "tiers": ["--cache-tiers", "exact,persistent,semantic",
              "--cache-semantic", "0.05", "--cascade", "0.6",
              "--fused-cascade"],
    "mesh": ["--mesh", "1,1", "--replicate-hot", "1", "--cascade", "0.6",
             "--fused-cascade"],
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_matches_jax(monkeypatch, capsys, tmp_path, artifacts, case):
    from repro.core import experiment as jex
    from repro_torch.core import experiment as tex
    jart, tart = artifacts
    monkeypatch.setattr(jex, "load_artifacts", lambda: jart)
    monkeypatch.setattr(tex, "load_artifacts", lambda: tart)
    common = ["--requests", "96", "--seq", "32", "--max-wait-s", "10",
              "--use-kernel"] + MAIN_CASES[case]
    runs = 2 if case == "tiers" else 1    # a restart over the same T2
    for run in range(runs):
        outs = []
        for pkg, extra in (("jax", []), ("port", ["--device", "cpu"])):
            metrics = str(tmp_path / f"{pkg}{run}.prom")
            args = common + extra + ["--metrics-out", metrics]
            if case == "tiers":           # each package its own T2
                args += ["--cache-dir", str(tmp_path / f"t2-{pkg}")]
            if pkg == "jax":
                summary = _jax_summary(monkeypatch, capsys, args)
            else:
                summary = tserve.main(args)
                printed = capsys.readouterr().out
                assert json.loads(printed[printed.index("\n{") + 1:]) == \
                    json.loads(json.dumps(summary))
            outs.append((summary, open(metrics).read()))
        (ref, jtext), (got, ttext) = outs
        assert got["device"] == "cpu"
        assert got["requests"] + got["engine"]["frontend"]["shed"] == 96
        (a, fa), (b, fb) = _comparable(ref), _comparable(got)
        assert b == a
        for key in fa:
            assert abs(fb[key] - fa[key]) <= TOL, key
        tiers = [ln for ln in ttext.splitlines()
                 if ln.startswith("tryage_cache_tier_hits_total{")]
        assert tiers == [ln for ln in jtext.splitlines()
                         if ln.startswith("tryage_cache_tier_hits_total{")]
        if case == "mesh":
            # the placement and streams' counts were held above (b == a)
            assert got["mesh"]["mesh"] == {"data": 1, "model": 1}
            assert got["mesh"]["placement"]["per_slice"] == {
                0: ["small", "mid", "big"]}
            assert sum(got["mesh"]["streams"]["flushes"]) == sum(
                got["engine"]["flushes"].values())
        else:
            assert got["mesh"] is ref["mesh"] is None
        if case == "tiers" and run == 1:
            # the restart answers every request from T2
            assert got["engine"]["cache"]["tiers"] == {"t2": 96}
            assert 'tryage_cache_tier_hits_total{tier="t2"} 96' in ttext


@pytest.mark.parametrize("flag", ["--sanitize", "--tile-table"])
def test_launch_tooling_flags_are_served(monkeypatch, capsys, tmp_path,
                                         artifacts, switches, flag):
    """``--sanitize`` and ``--tile-table`` run in both packages: the same
    summary as the JAX CLI's (``"sanitize": true``), and the port's
    kernels consult the given table (its ``router_tiles`` carry the
    table's k-groups; the JAX package reads no entry of it)."""
    from repro.core import experiment as jex
    from repro_torch.core import experiment as tex
    from repro_torch.kernels import sanitize as tsan
    from repro_torch.kernels import tiles as ttiles
    jart, tart = artifacts
    monkeypatch.setattr(jex, "load_artifacts", lambda: jart)
    monkeypatch.setattr(tex, "load_artifacts", lambda: tart)
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    extra = [flag]
    if flag == "--tile-table":
        path = tmp_path / "table.json"
        path.write_text(json.dumps({"version": 1, ttiles.backend_key(): {
            "router_score": {"1": {"k_groups": 2}, "16": {"k_groups": 32}},
            "router_cascade": {"1": {"k_groups": 1}}}}))
        extra.append(str(path))
    common = ["--requests", "96", "--seq", "32", "--max-wait-s", "10",
              "--use-kernel", "--cascade", "0.6", "--fused-cascade"] + extra
    ref = _jax_summary(monkeypatch, capsys, common)
    got = tserve.main(common + ["--device", "cpu"])
    assert got["sanitize"] is ref["sanitize"] is (flag == "--sanitize")
    assert tsan.sanitize_enabled() is (flag == "--sanitize")
    plans = got["engine"]["router_tiles"]
    (a, fa), (b, fb) = _comparable(ref), _comparable(got)
    assert b == a
    for key in fa:
        assert abs(fb[key] - fa[key]) <= TOL, key
    if flag == "--tile-table":
        assert ttiles.table_path() == str(path)
        assert plans["router_cascade"]
        for name, by_batch in plans.items():
            for B, plan in by_batch.items():
                want = ttiles.tile_for(name, B, "k_groups", -1)
                assert plan["k_groups"] == want != -1
