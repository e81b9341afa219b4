"""``correct`` against its control and its faults, on the CPU at tiny
widths with each cell's own limits.

- The program passes.
- The control (the reference at the precision below the configuration's,
  in the program's place: TF32 products for float32, fp8 products for
  bfloat16) fails.
- A run with the timed path broken underneath fails, for each fault the
  cell can have: a token or an answer altered where it is produced,
  half of a batch left out, a decode step that returns its state
  unchanged.  (Nothing here runs across chips.)

The chip runs of ``bench/calibrate.py`` read the same at the cells'
own sizes (PERF.md).
"""

import time

import pytest
import torch

import tiny
from harness import core
from harness.checks import CONTROL

CELLS = [w["name"] for w in tiny.SPEC["workloads"]]


def run(name, seconds=0.6, seed=5):
    return core.run_cell(tiny.cell(name), seed, seconds, False, "cpu",
                         time.monotonic())


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    c = tiny.cell(name)
    r = c.system.Run(c.cfg, c.mix, c.ref, c.adapter, 6, torch.device("cpu"))
    r.setup()
    r.window(0.6)
    r.release()
    numbers = r.check(control=CONTROL[c.cfg["dtype"]])
    over = {k: v for k, v in numbers.items() if v > c.limits[k]}
    assert over, (numbers, c.limits)


# ------------------------------------------------------------- faults


def _tryage_token(monkeypatch):
    from repro_torch.serving.engine import TryageEngine
    orig = TryageEngine._expert_forward

    def fault(model, toks, targets, mask):
        preds, loss, acc = orig(model, toks, targets, mask)
        preds = preds.clone()
        preds[:, 2] = (preds[:, 2] + 1) % model.cfg.vocab_size
        return preds, loss, acc

    monkeypatch.setattr(TryageEngine, "_expert_forward", staticmethod(fault))


def _tryage_answer(monkeypatch):
    from repro_torch.kernels.router_score import ops
    orig = ops.router_route

    def fault(emb, head, constraints, lambdas):
        pred, choice = orig(emb, head, constraints, lambdas)
        return pred, (choice + 1) % pred.shape[1]

    monkeypatch.setattr(ops, "router_route", fault)


def _tryage_half_batch(monkeypatch):
    from repro_torch.serving.engine import TryageEngine
    orig = TryageEngine._expert_forward

    def fault(model, toks, targets, mask):
        preds, loss, acc = orig(model, toks, targets, mask)
        h = max(1, len(loss) // 2)
        loss = loss.clone()
        loss[h:] = loss[:h].mean()
        return preds, loss, acc

    monkeypatch.setattr(TryageEngine, "_expert_forward", staticmethod(fault))


def _prefill_token(monkeypatch):
    from repro_torch.launch import steps
    orig = steps.prefill_step

    def fault(*a, **kw):
        last, state = orig(*a, **kw)
        last = last.clone()
        last[:, (last.argmax(-1) + 1) % last.shape[1]] += 1e3
        return last, state

    monkeypatch.setattr(steps, "prefill_step", fault)


def _decode_token(monkeypatch):
    from repro_torch.launch import steps
    orig = steps.serve_step

    def fault(model, state, tokens, index, **kw):
        nxt, state = orig(model, state, tokens, index, **kw)
        return (nxt + 1) % model.cfg.vocab_size, state

    monkeypatch.setattr(steps, "serve_step", fault)


def _decode_half_batch(monkeypatch):
    from repro_torch.launch import steps
    orig = steps.serve_step

    def fault(model, state, tokens, index, **kw):
        nxt, state = orig(model, state, tokens, index, **kw)
        h = nxt.shape[0] // 2
        nxt = nxt.clone()
        nxt[h:] = nxt[:h][: nxt.shape[0] - h]
        return nxt, state

    monkeypatch.setattr(steps, "serve_step", fault)


def _decode_state_unchanged(monkeypatch):
    from repro_torch.launch import steps
    orig = steps.serve_step

    def fault(model, state, tokens, index, **kw):
        nxt, _ = orig(model, state, tokens, index, **kw)
        return nxt, state

    monkeypatch.setattr(steps, "serve_step", fault)


FAULTS = [
    ("bert11-backlog-s512", _tryage_token),
    ("bert11-backlog-s512", _tryage_answer),
    ("bert11-backlog-s512", _tryage_half_batch),
    ("sc2-prefill-2k", _prefill_token),
    ("sc2-decode-b32", _decode_token),
    ("sc2-decode-b32", _decode_half_batch),
    ("sc2-decode-b32", _decode_state_unchanged),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run(name)
    assert not out["correct"], out["checks"]
