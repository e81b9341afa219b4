"""Loops counted by trip count (``repro_torch.launch.op_costs``:
``repeat``, ``counted_loop``), the port's counterpart of the
reference's while-body weighting (``repro.launch.hlo_loops``).

* ``repeat`` scopes multiply what the counter adds, and nest by
  multiplying: the nested-scan example of ``tests/test_hlo_loops.py``
  counts what ``loop_aware_totals`` counts, by explicit scopes and by
  nested ``counted_loop``s on ``meta``;
* the reduced xlstm's steps traced on ``meta`` (the sLSTM's time loop and
  its chunk loop counted by trip count) count exactly what the same step
  counts on CPU tensors, where every iteration runs: ``n_ops``,
  ``dot_flops``, ``traffic_bytes``, the histogram, the kernels and the
  collectives; ``peak_bytes`` within 2%.  Prefill and train (remat on
  and off), microbatch 1 and 2, one card and a (2, 2) mesh of a fake
  4-rank world, T in {1, 2, 3, 64, 256};
* one sLSTM layer (forward and backward) at chunks short enough that
  the chunk loop is counted too: the same, and ``peak_bytes`` too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, op_costs
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.steps import PerfKnobs
from repro_torch.models import ssm
from repro_torch.models.common import InputShape
from torch_threads import one_torch_thread  # noqa: F401

EXACT = ("n_ops", "dot_flops", "traffic_bytes", "op_histogram", "kernels",
         "collectives")
PEAK_REL = 0.02
CFG = get_config("xlstm-1.3b").reduced(d_model=64)


def _assert_same(got, want, peak_got, peak_want):
    for key in EXACT:
        assert got[key] == want[key], (key, got[key], want[key])
    assert abs(peak_got - peak_want) <= PEAK_REL * peak_want, (
        peak_got, peak_want)


# ------------------------------------------------------------- repeat

def _wx():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((8, 64, 64))
                             .astype(np.float32)),
            torch.from_numpy(rng.standard_normal((4, 64))
                             .astype(np.float32)))


def test_repeat_multiplies_every_counter():
    W, x = _wx()
    log = op_costs.KernelLog()
    with op_costs.OpCounter() as once:
        torch.tanh(x @ W[0])
        op_costs.kernel_call("k", lambda: (10, 20), lambda: None)
    with op_costs.OpCounter() as c, log:
        with op_costs.repeat(3):
            torch.tanh(x @ W[0])
            op_costs.kernel_call("k", lambda: (10, 20), lambda: None)
    a, b = once.totals(), c.totals()
    assert b["n_ops"] == 3 * a["n_ops"] == 6
    assert b["op_histogram"] == {"mm": 3, "tanh": 3}
    assert b["dot_flops"] == 3 * a["dot_flops"]
    assert b["traffic_bytes"] == 3 * a["traffic_bytes"]
    assert b["kernels"] == {"k": {"calls": 3, "flops": 30.0, "bytes": 60.0}}
    assert log.kernels == b["kernels"]
    assert op_costs._mult == 1 and not op_costs._REPEATS
    with pytest.raises(ValueError):
        with op_costs.repeat(0):
            pass


def test_repeat_nests_multiplicatively():
    """3 x 8 iterations of ``tanh(h @ W[i])``: the reference's nested
    scan counts 3 * 8 * 2 * 4 * 64 * 64 dot FLOPs
    (``test_dot_flops_match_loop_aware_totals_nested``); two scopes
    traced once count the same, and so do two nested ``counted_loop``s
    on meta, each tracing 3 iterations."""
    W, x = _wx()
    want = 3 * 8 * 2 * 4 * 64 * 64
    with op_costs.OpCounter() as c:
        with op_costs.repeat(3), op_costs.repeat(8):
            torch.tanh(x @ W[0])
    assert c.totals()["dot_flops"] == want
    assert c.totals()["op_histogram"] == {"mm": 24, "tanh": 24}

    Wm, xm = W.to("meta"), x.to("meta")

    def inner(h, w):
        h = torch.tanh(h @ w)
        return h, h

    def outer(h, _):
        h, _ = op_costs.counted_loop(inner, h, Wm.unbind(0), "inner")
        return h, h

    with op_costs.OpCounter() as m:
        op_costs.counted_loop(outer, xm, [xm] * 3, "outer")
    tot = m.totals()
    assert tot["dot_flops"] == want
    assert tot["op_histogram"] == {"mm": 24, "tanh": 24}
    assert tot["loops"] == [
        {"name": "inner", "trip_count": 8, "runs": 3, "traced_runs": 3,
         "iterations_traced": 9},
        {"name": "outer", "trip_count": 3, "runs": 1, "traced_runs": 1,
         "iterations_traced": 3}]


# --------------------------------------------- steps against unrolled

def _trace(kind, T, knobs, device, mesh=False):
    shape = InputShape(kind, T, 4 if mesh else 2, kind)
    if not mesh:
        return dryrun.trace_step(CFG, shape, knobs, device=device, top=None)
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(4):
        dmesh = init_device_mesh("cpu", (2, 2),
                                 mesh_dim_names=("data", "model"))
        return dryrun.trace_step(CFG, shape, knobs, mesh=dmesh,
                                 device=device, top=None)


CASES = (
    [("prefill", T, True, 1, False) for T in (1, 2, 3, 64, 256)]
    + [("train", T, True, 1, False) for T in (1, 2, 3, 64, 256)]
    + [("train", 64, False, 1, False), ("train", 64, True, 2, False),
       ("train", 3, False, 2, False), ("prefill", 64, True, 1, True),
       ("train", 8, False, 2, True)])


@pytest.mark.parametrize("kind,T,remat,mb,mesh", CASES)
def test_meta_counts_equal_the_unrolled_run(kind, T, remat, mb, mesh):
    knobs = PerfKnobs(microbatch=mb, remat=remat)
    got = _trace(kind, T, knobs, "meta", mesh)
    want = _trace(kind, T, knobs, "cpu", mesh)
    _assert_same(got["cost"], want["cost"], got["memory"]["temp_bytes"],
                 want["memory"]["temp_bytes"])
    loops = {l["name"]: l for l in got["cost"]["loops"]}
    if T >= 3:
        steps = loops["slstm.steps"]
        assert steps["trip_count"] == min(T, 128)
        # forward, and under remat the group's recompute, then the
        # chunk's recompute in the backward: per chunk and microbatch
        per = 1 if kind == "prefill" else (3 if remat else 2)
        assert steps["runs"] == per * mb * (T // steps["trip_count"])
        assert steps["iterations_traced"] == 3 * steps["traced_runs"]
    else:
        assert not loops
    if mesh:
        assert got["cost"]["collectives"]["total_count"] > 0


# -------------------------------------------------- one sLSTM layer

def _slstm_layer(device, T, chunk, grad):
    g = torch.Generator().manual_seed(0)
    p = ssm.init_slstm(g, CFG)
    x = torch.randn(2, T, CFG.d_model, generator=g)
    if device == "meta":
        p = type(p)({k: torch.nn.Parameter(v.to("meta"))
                     for k, v in p.items()})
        x = x.to("meta")
    x.requires_grad_(grad)
    with op_costs.OpCounter() as c, torch.set_grad_enabled(grad):
        y, st = ssm.slstm_full(p, x, CFG, chunk=chunk)
        if grad:
            (y.sum() + st["c"].sum()).backward()
        del y, st
    return c


@pytest.mark.parametrize("T,chunk,grad", [(3, 128, True), (64, 128, True),
                                          (48, 16, True), (240, 16, True),
                                          (256, 16, False)])
def test_slstm_layer_counts_and_peak_equal_the_unrolled_run(T, chunk, grad):
    got, want = (_slstm_layer(d, T, chunk, grad) for d in ("meta", "cpu"))
    _assert_same(got.totals(None), want.totals(None), got.peak_bytes,
                 want.peak_bytes)
    assert got.peak_bytes == want.peak_bytes
    loops = {(l["name"], l["trip_count"]): l["runs"]
             for l in got.totals()["loops"]}
    n = T // min(chunk, T)
    ck = T // n
    if n >= 3:
        assert loops[("slstm.chunks", n)] == 1
    # each chunk's loop, again in its recompute under autograd
    assert loops[("slstm.steps", ck)] == n * (2 if grad else 1)
    assert op_costs._mult == 1 and not op_costs._REPEATS


def test_unit_groups_of_two_are_traced():
    """A 16-layer reduced xlstm at unit_group 2 (train_4k's knobs): two
    units under one checkpoint, each chunk's under its own inside."""
    cfg = dataclasses.replace(CFG, num_layers=16)
    knobs = PerfKnobs(unit_group=2)
    shape = InputShape("train", 8, 2, "train")
    got = dryrun.trace_step(cfg, shape, knobs, device="meta", top=None)
    want = dryrun.trace_step(cfg, shape, knobs, device="cpu", top=None)
    _assert_same(got["cost"], want["cost"], got["memory"]["temp_bytes"],
                 want["memory"]["temp_bytes"])
