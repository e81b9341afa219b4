"""One run of one cell: find its files by name, set up, measure the
window, read the metrics, and judge the answers against the reference.

A cell is a ``workloads`` entry of ``BENCHMARK.json``.  Its files:

- ``bench/configs/<config>.json`` (the configuration, the entry's
  ``file``) and ``bench/configs/<config>.py`` (builds the system under
  test from it and the benchmark's weights);
- ``bench/reference/<config>.py``, the plain reference;
- ``bench/traffic/<traffic>.json``, the traffic mix;
- ``bench/limits/<workload>.json``, the limit of each compared number;
- ``bench/metrics/<metric>.py`` for each per-layer metric, whose
  ``read(run)`` returns the number or None;
- ``harness/systems/<system>.py``, the driver the configuration names.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from costs import flops as costs
from harness.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_file(path: Path):
    """The Python module in ``path`` (its name may hold '-' and '.')."""
    name = "bench_file_" + "".join(c if c.isalnum() else "_"
                                   for c in str(path.relative_to(BENCH)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A workload of ``spec`` and everything found by its names."""

    def __init__(self, spec: dict, name: str):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(by_name)})")
        self.workload = w = by_name[name]
        entry = next(c for c in spec["configs"] if c["name"] == w["config"])
        cfg_file = ROOT / entry["file"]
        self.cfg = load_json(cfg_file)
        self.adapter = load_file(cfg_file.with_suffix(".py"))
        self.ref = load_file(BENCH / "reference" / f"{w['config']}.py")
        self.mix = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.system = importlib.import_module(
            f"harness.systems.{self.cfg['system']}")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]


def _device_info(cell: Cell, dev: torch.device, mem: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell.workload["chips"], "memory_peak_bytes": mem}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": mem}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> dict:
    """The result of one run (without the JAX check and the printing)."""
    dev = torch.device(device)
    tracer = Trace(dev) if trace else None
    run = cell.system.Run(cell.cfg, cell.mix, cell.ref, cell.adapter, seed,
                          dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if tracer is not None:
        tracer.install()
        tracer.warm()
    t_setup = time.monotonic()
    try:
        run.setup()
        setup_s = time.monotonic() - t_process
        e2e = run.window(seconds, tracer)
    finally:
        if tracer is not None:
            tracer.uninstall()
    mem = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        mem = torch.cuda.max_memory_allocated(dev)
    run.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = run.check()
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if not trace:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = dict(run.layer, trace=tracer.summary, costs=costs)
        for m in cell.per_layer:
            v = load_file(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics,
           "device": _device_info(cell, dev, mem)}
    if trace:
        s = tracer.summary
        out["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = {"device_ops": s["device_ops"],
                            "idle_gaps": s["idle_gaps"]}
    out["setup_phases"] = dict(run.phases, before_setup=t_setup - t_process)
    if run.notes:
        out["notes"] = run.notes
    out["checks"] = checks
    return out


def check_lines(result: dict) -> list:
    """Each compared number beside its limit, one line each."""
    return [f"check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in result["checks"].items()]
