"""The port's metrics export (``repro_torch.serving.metrics``).

* The registry equals the JAX package's, series by series (name, type,
  labels, help, source), and matches the ``docs/METRICS.md`` table by
  the checks of ``tests/test_metrics_docs.py``, so the document holds
  for both packages.  The table check needs no JAX.
* ``render()`` of both packages on the stats and health of the same
  ``serve()`` run (cascade, shedding front end, health tracker,
  injected failures) gives the same text, apart from the two wall-time
  series (``tryage_router_time_seconds_total``,
  ``tryage_expert_time_seconds_total``).
* ``start_metrics_server(0, ...)`` serves the rendering at ``GET
  /metrics`` and stops cleanly; ``render()`` keeps the exposition
  format invariants of ``tests/test_metrics.py``.
"""

import dataclasses
import pathlib
import re
import urllib.error
import urllib.request

import pytest

from repro_torch.serving import EngineStats
from repro_torch.serving.metrics import (CONTENT_TYPE, LATENCY_BUCKETS,
                                         METRICS, metric_names, render,
                                         start_metrics_server)

DOC = pathlib.Path(__file__).resolve().parent.parent / "docs" / "METRICS.md"
WALL_TIME = ("tryage_router_time_seconds_total",
             "tryage_expert_time_seconds_total")


# ------------------------------------------- registry and docs/METRICS.md


def _table_rows():
    text = DOC.read_text()
    m = re.search(r"<!-- metrics-table-start -->\n(.*?)"
                  r"<!-- metrics-table-end -->", text, re.DOTALL)
    assert m, "metrics table markers missing from docs/METRICS.md"
    header, sep, *rows = [ln for ln in m.group(1).strip().splitlines()
                          if ln.startswith("|")]
    assert [c.strip() for c in header.strip("|").split("|")] == \
        ["Name", "Type", "Labels", "Source", "Meaning"]
    assert set(sep) <= {"|", "-", " "}
    return [[c.strip() for c in row.strip("|").split("|")] for row in rows]


def _unticked(cell):
    assert cell.startswith("`") and cell.endswith("`"), cell
    return cell[1:-1]


def test_docs_table_matches_the_port_registry():
    rows = _table_rows()
    assert all(len(r) == 5 for r in rows)
    assert [_unticked(r[0]) for r in rows] == metric_names()
    for row, spec in zip(rows, METRICS):
        assert row[1] == spec.mtype, spec.name
        assert row[2] == ("-" if not spec.labels
                          else ", ".join(spec.labels)), spec.name
        assert _unticked(row[3]) == spec.source, spec.name
        assert row[4] == spec.help, spec.name
    assert len(set(metric_names())) == len(rows)


def test_registry_equals_jax_registry():
    pytest.importorskip("jax")
    from repro.serving.metrics import LATENCY_BUCKETS as JBUCKETS
    from repro.serving.metrics import METRICS as JMETRICS
    assert [dataclasses.astuple(m) for m in METRICS] == [
        dataclasses.astuple(m) for m in JMETRICS]
    assert LATENCY_BUCKETS == JBUCKETS


# ------------------------------------------------ render against the JAX


def _without_wall_time(text):
    return [ln for ln in text.splitlines()
            if not any(name in ln for name in WALL_TIME)]


def test_render_matches_jax_on_the_same_run(tiny_library):
    pytest.importorskip("jax")
    from repro.serving import ExpertHealth as JHealth
    from repro.serving import ServingFrontend as JFrontend
    from repro.serving import Session as JSession
    from repro.serving.metrics import render as jax_render
    from repro_torch.serving import ExpertHealth, ServingFrontend, Session
    from repro_torch.serving import Request as TRequest
    from torch_serving_util import (Clock, JRequest, make_engines,
                                    make_weights, workload)

    healths = (JHealth(3, now_fn=Clock(), cooldown_s=0.0),
               ExpertHealth(3, now_fn=Clock(), cooldown_s=0.0))
    jeng, teng = make_engines(tiny_library, make_weights(tiny_library),
                              lane_target=8, max_wait_s=1e9,
                              fused_cascade=True,
                              jax_knobs={"health": healths[0]},
                              port_knobs={"health": healths[1]})
    work = workload(cascade=True)[:96]
    names = [e.name for e in tiny_library.experts]
    texts = []
    for eng, health, fe_cls, s_cls, r_cls, render_fn in (
            (jeng, healths[0], JFrontend, JSession, JRequest, jax_render),
            (teng, healths[1], ServingFrontend, Session, TRequest, render)):
        def arrivals(eng=eng, r_cls=r_cls, part=0):
            for i, w in enumerate(work[part::2]):
                if i == 0 and part == 0:
                    eng.scheduler.inject_failures(2, 2)
                yield r_cls(**w, priority=w["uid"] % 3)
        fe = fe_cls(eng, [s_cls("a", arrivals()),
                          s_cls("b", arrivals(part=1))], capacity=8)
        results = list(fe.serve())
        assert eng.stats.shed > 0 and eng.stats.reroutes > 0
        texts.append(render_fn(eng.stats, health, names))
        assert f"tryage_requests_served_total {len(results)}" in texts[-1]
    assert _without_wall_time(texts[1]) == _without_wall_time(texts[0])


# ----------------------------- exposition format and the scrape endpoint


def _families(text):
    """{family: (type, [samples])}, holding HELP, TYPE, samples order."""
    fams, lines, i = {}, text.splitlines(), 0
    assert text.endswith("\n") and lines
    while i < len(lines):
        assert lines[i].startswith("# HELP "), lines[i]
        name = lines[i].split()[2]
        assert lines[i + 1].startswith(f"# TYPE {name} ")
        mtype = lines[i + 1].split()[3]
        i += 2
        samples = []
        while i < len(lines) and not lines[i].startswith("#"):
            samples.append(lines[i])
            i += 1
        assert name not in fams
        fams[name] = (mtype, samples)
    return fams


def _stats():
    st = EngineStats()
    st.served, st.shed, st.failed = 7, 2, 1
    st.per_expert.update({"small": 4, 'we"ird\\name': 3})
    st.shed_by_priority[0] = 2
    st.flushes.update({"target": 2, "deadline": 1})
    st.latencies.extend([0.002, 0.004, 0.03, 0.2])
    return st


def test_render_covers_the_registry_in_order():
    fams = _families(render(_stats()))
    assert list(fams) == metric_names()
    for m in METRICS:
        assert fams[m.name][0] == m.mtype
        assert (m.mtype == "counter") == m.name.endswith("_total")
    assert fams["tryage_requests_served_total"][1] == [
        "tryage_requests_served_total 7"]
    assert fams["tryage_flushes_total"][1] == [
        'tryage_flushes_total{reason="deadline"} 1',
        'tryage_flushes_total{reason="target"} 2']
    assert r'{expert="we\"ird\\name"} 3' in render(_stats())
    for name in ("tryage_expert_healthy", "tryage_expert_failure_ewma"):
        assert fams[name][1] == []          # no tracker: headers only


def test_render_latency_histogram():
    samples = _families(render(_stats()))[
        "tryage_request_latency_seconds"][1]
    buckets = [s for s in samples if "_bucket" in s]
    counts = [float(s.rsplit(" ", 1)[1]) for s in buckets]
    assert len(buckets) == len(LATENCY_BUCKETS) + 1
    assert counts == sorted(counts) and counts[-1] == 4
    assert 'le="0.005"} 2' in buckets[1]
    assert samples[-1] == "tryage_request_latency_seconds_count 4"


def test_metrics_server_round_trip():
    stats = _stats()
    srv = start_metrics_server(0, lambda: render(stats))
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=5) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == CONTENT_TYPE
            assert list(_families(resp.read().decode())) == metric_names()
        stats.served = 99                   # a fresh collect() per scrape
        with urllib.request.urlopen(url, timeout=5) as resp:
            assert "tryage_requests_served_total 99" in resp.read().decode()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope",
                                   timeout=5)
        assert err.value.code == 404
    finally:
        srv.stop()
    srv._thread.join(timeout=5)
    assert not srv._thread.is_alive()
