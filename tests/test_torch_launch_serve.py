"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``).

* ``poisson_arrivals`` on a fake clock yields the same sequence of
  requests and idle ticks, with the same arrival stamps;
* ``parse_priority_mix`` gives the same fractions;
* every ``ap.error`` of the JAX driver fires alike with the same
  message, except the one the port drops on purpose
  (``--fused-cascade`` without ``--use-kernel``: the port always decides
  through its kernels); the flags of subsystems not ported yet
  (``--mesh``, ``--replicate-hot``, ``--tile-table``, ``--sanitize``)
  are refused; without a card and without ``--device`` the command
  raises instead of serving on the CPU;
* ``main()`` of both packages on the CPU over the same tiny artifacts
  (``tiny_library``, one router with an uncertainty head, a vocab-64
  corpus; ``load_artifacts`` monkeypatched, the port with ``--device
  cpu``) gives the same summary JSON in every field but the wall-clock
  ones (``wall_s``, ``req_per_s``, latency percentiles, router, expert
  and adaptation seconds), the port's launch plans (``router_tiles``,
  the CUDA kernels' geometry, not the Pallas tiles) and the port's
  extra ``device``.  ``--max-wait-s 10`` keeps deadlines out of the
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


@pytest.mark.parametrize("argv", [["--mesh", "1,1"], ["--replicate-hot", "1"],
                                  ["--tile-table", "tiles.json"],
                                  ["--sanitize"]],
                         ids=lambda a: a[0])
def test_flags_not_ported_are_refused(capsys, argv):
    with pytest.raises(SystemExit) as err:
        tserve.main(argv + ["--device", "cpu"])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert f"{argv[0]} is not ported yet" in msg and "ROADMAP" in msg


def test_serving_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--requests", "4"])


# ---------------------------------------------------- main() against JAX


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
        if case == "tiers" and run == 1:
            # the restart answers every request from T2
            assert got["engine"]["cache"]["tiers"] == {"t2": 96}
            assert 'tryage_cache_tier_hits_total{tier="t2"} 96' in ttext
