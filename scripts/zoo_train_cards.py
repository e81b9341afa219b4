#!/usr/bin/env python3
"""Train configs of the zoo at published width across cards through the
sharded steps: one NCCL rank a card.

    python3 scripts/zoo_train_cards.py [--cases tinyllama:1x2 ...] [--cpu]
                                       [--out FILE]

Each case spawns one rank per device of its (data, model) mesh, rank r
on card r, over a ``FileStore`` in a temporary directory (no network);
the kernels are built once before the ranks start.  Every rank draws
the same weights and batch from the seed, lays the model out with
``launch.steps.shard_model`` (its bf16 copy freed before ``adamw_init``
makes the moments, so no card holds the unsharded AdamW state) and runs
``train_step(mesh=)``.  Cases:

* ``tinyllama:DxM`` (1x2, 2x1, 2x2): tinyllama-1.1b at full width and
  depth in f32: one ``train_step`` (4 x 512, lr 1e-3), ``prefill_step``
  and 8 greedy ``serve_step``s against the meshless steps on the rank's
  own card from the same weights.  The loss within rtol 1e-4; each
  gradient leaf (read from the first AdamW moment) within 1e-3 of its
  largest magnitude and each weight after the step within that or 6 lr
  (Adam's first step moves a weight by about lr, whatever the rounding
  of a near-zero gradient); the greedy tokens identical up to the first
  step whose meshless top-two logit gap is under 1e-4; the kernel
  launches of the sharded train step and prefill equal to the
  meshless ones.  Sums split across cards, so bit for bit no longer
  holds.
* ``qwen2-moe:2x2``: qwen2-moe-a2.7b at all 24 layers in bf16, 4 x 512,
  5 steps at lr 1e-4; ``jamba:2x2``: jamba-v0.1-52b's first 8-layer unit (7 Mamba
  layers and the attention layer, 4 MoE MLPs) in bf16, 2 x 2048, 5
  steps.  The loss must fall and each step launch the attention
  forward twice (remat) and its backward once per attention layer;
  each rank reports its launches, the (token, expert) pairs its MoE
  layers dropped at capacity in each step's forward, its card's peak
  memory and ms a step.

``--cpu`` runs the same cases on gloo ranks on the CPU at the configs'
``reduced()`` widths and a few tokens: it checks the script, not the
numbers.  Prints one JSON object (and writes it to ``--out``): the
card's name and power limit (as ``nvidia-smi`` gives them) and each
case's result; exits non-zero when a case failed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CASES = ("tinyllama:1x2", "tinyllama:2x1", "tinyllama:2x2",
         "qwen2-moe:2x2", "jamba:2x2")
LOSS_RTOL, LEAF_REL, TOKEN_GAP = 1e-4, 1e-3, 1e-4
# the training cases take chip_smoke.py zoo_train's lr for the configs
# added with them: at 1e-3 jamba's loss swung 11.51 -> 0.07 -> 10.76
PARITY_LR, TRAIN_LR, TRAIN_STEPS = 1e-3, 1e-4, 5
# (arch, fields cut, dtype, batch, seq) of each case on the cards; --cpu
# takes the reduced() config and SMALL's batch and seq instead
RUNS = {"tinyllama": ("tinyllama-1.1b", None, "float32", 4, 512),
        "qwen2-moe": ("qwen2-moe-a2.7b", None, "bfloat16", 4, 512),
        "jamba": ("jamba-v0.1-52b", {"num_layers": 8}, "bfloat16", 2, 2048)}
SMALL = {"tinyllama": (4, 16), "qwen2-moe": (4, 16), "jamba": (2, 32)}
DECODE_STEPS = 8


def case_config(name: str, cpu: bool):
    from repro_torch.configs import get_config
    arch, cut, dtype, B, S = RUNS[name]
    cfg = get_config(arch)
    if cpu:
        cfg = cfg.reduced(num_layers=max(2, len(cfg.layer_pattern)),
                          d_model=64)
        B, S = SMALL[name]
    elif cut:
        cfg = dataclasses.replace(cfg, **cut)
    return dataclasses.replace(cfg, dtype=dtype), B, S


def case_batch(cfg, B, S, seed=0) -> dict:
    """The training CLI's batch for ``cfg`` from seeded token ids."""
    from repro_torch.launch.train import family_batch
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return family_batch(cfg, toks, rng)


def rel_err(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def whole(t):
    from repro_torch.sharding.context import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def sharded_copy(cfg, seed, dev, mesh, rules):
    """The model drawn on ``dev`` from ``seed``, laid out on ``mesh``
    (the whole copy freed), and its AdamW state made sharded."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw_init
    model = model_lib.init_model(cfg, seed=seed, device=dev)
    steps.shard_model(model, mesh, rules)
    if dev != "cpu":
        torch.cuda.empty_cache()
    return model, adamw_init(model)


def parity(cfg, B, S, dev, mesh) -> dict:
    """Case (a): the sharded train step, prefill and greedy decode
    against the meshless ones on this rank's device."""
    import torch

    from repro_torch.kernels import launches
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw_init

    batch = case_batch(cfg, B, S)
    ref = model_lib.init_model(cfg, seed=3, device=dev)
    ref_opt = adamw_init(ref)
    p0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
    rules = steps.rules_for(mesh)
    model, opt = sharded_copy(cfg, 3, dev, mesh, rules)
    out, counts = {}, {}
    launches.reset_launch_counts()
    want = steps.train_step(ref, ref_opt, batch, lr=PARITY_LR, device=dev)
    counts["meshless_train"] = launches.launch_counts()
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    got = steps.train_step(model, opt, batch, lr=PARITY_LR, device=dev,
                           mesh=mesh)
    got = float(got.full_tensor())
    out["sharded_train_s"] = time.perf_counter() - t0
    counts["sharded_train"] = launches.launch_counts()
    out["loss"] = [got, float(want)]
    out["loss_rel_err"] = abs(got - float(want)) / abs(float(want))
    assert out["loss_rel_err"] <= LOSS_RTOL, f"loss {out['loss']}"
    grad_worst, weight_worst = (0.0, None), (0.0, None)
    for name, p in ref.named_parameters():
        # the first moment after one step is (1 - b1) times the gradient
        e = rel_err(whole(opt.mu[name]), ref_opt.mu[name])
        assert e <= LEAF_REL, f"gradient of {name}: {e}"
        grad_worst = max(grad_worst, (e, name))
        w, w_ref = whole(model.get_parameter(name)), ref.get_parameter(name)
        diff = float((w.double() - w_ref.double()).abs().max())
        tol = max(LEAF_REL * float(p0[name].abs().max()), 6 * PARITY_LR)
        assert diff <= tol, f"weight {name}: {diff} > {tol}"
        weight_worst = max(weight_worst, (diff / tol, name))
        del w
    out["worst_grad_rel_err"], out["worst_grad_leaf"] = grad_worst
    out["worst_weight_err_over_tol"], out["worst_weight_leaf"] = weight_worst
    del p0, ref_opt, opt

    cap = S + DECODE_STEPS
    toks = {"tokens": batch["tokens"]}
    launches.reset_launch_counts()
    want_l, want_st = steps.prefill_step(ref, toks, cache_capacity=cap,
                                         device=dev)
    counts["meshless_prefill"] = launches.launch_counts()
    launches.reset_launch_counts()
    got_l, got_st = steps.prefill_step(model, toks, cache_capacity=cap,
                                       device=dev, mesh=mesh)
    counts["sharded_prefill"] = launches.launch_counts()
    for k in ("train", "prefill"):
        assert counts[f"sharded_{k}"] == counts[f"meshless_{k}"], counts
    out["prefill_logits_rel_err"] = rel_err(got_l.full_tensor(), want_l)
    tok_w = want_l.argmax(-1).to(torch.int32)[:, None]
    tok_g = got_l.full_tensor().argmax(-1).to(torch.int32)[:, None]
    gaps, held, logits = [], None, want_l
    for i in range(DECODE_STEPS + 1):
        top2 = logits.float().topk(2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        if held is None and gaps[-1] < TOKEN_GAP:
            held = i      # a near tie: this token and the rest not held
        if held is None and not torch.equal(tok_g, tok_w):
            raise AssertionError(f"greedy token {i}: {tok_g.tolist()} != "
                                 f"{tok_w.tolist()}")
        if i == DECODE_STEPS:
            break
        # the meshless serve_step's body, keeping its logits for the gap
        with torch.inference_mode():
            logits, want_st = model_lib.decode_step(
                ref, {"tokens": tok_w}, want_st, S + i)
        tok_w = logits.argmax(-1).to(torch.int32)[:, None]
        tok_g, got_st = steps.serve_step(model, got_st, tok_g, S + i,
                                         device=dev, mesh=mesh)
        tok_g = tok_g.full_tensor()
    out.update(top2_gaps=gaps, tokens_held=(DECODE_STEPS + 1 if held is None
                                            else held),
               launches=counts)
    return out


@contextlib.contextmanager
def moe_drops():
    """Each ``models.moe.route`` call's (pairs, dropped pairs) while
    active, the dropped count a device tensor (no sync)."""
    from repro_torch.models import moe
    calls, route = [], moe.route

    def counted(*args, **kwargs):
        r = route(*args, **kwargs)
        calls.append((r.keep.numel(), (~r.keep).sum()))
        return r

    moe.route = counted
    try:
        yield calls
    finally:
        moe.route = route


def train(cfg, B, S, dev, mesh) -> dict:
    """Cases (b), (c): TRAIN_STEPS sharded steps from one batch."""
    import torch

    from repro_torch.kernels import launches
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib

    cuda = dev != "cpu"
    rules = steps.rules_for(mesh)
    t0 = time.perf_counter()
    model, opt = sharded_copy(cfg, 5, dev, mesh, rules)
    batch = case_batch(cfg, B, S)
    setup_s = time.perf_counter() - t0
    local = sum(t.to_local().numel() * t.element_size()
                for t in [*model.parameters(), *opt.mu.values(),
                          *opt.nu.values()])
    full = sum(p.numel() * (p.element_size() + 8)
               for p in model.parameters())
    assert local < full, f"the AdamW state is not sharded: {local} bytes"
    peak_build = torch.cuda.max_memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    n_moe = sum(b.use_moe for b in model.layers)
    n_attn = sum(k == "attn" for k in (
        cfg.layer_pattern[i % len(cfg.layer_pattern)]
        for i in range(cfg.num_layers)))
    losses, step_s, per_step, drops = [], [], [], []
    with moe_drops() as calls:
        for _ in range(TRAIN_STEPS):
            del calls[:]
            launches.reset_launch_counts()
            t1 = time.perf_counter()
            loss = steps.train_step(model, opt, batch, lr=TRAIN_LR,
                                    device=dev, mesh=mesh)
            losses.append(float(loss.full_tensor()))  # syncs the card
            step_s.append(time.perf_counter() - t1)
            per_step.append(launches.launch_counts())
            fwd = calls[:n_moe]        # the forward's calls come first
            drops.append([sum(n for n, _ in fwd),
                          int(sum(int(d) for _, d in fwd))])
    # on the CPU the wrappers run their plain versions: no launch
    want = {"flash_attention": 2 * n_attn * cuda,
            "flash_attention_bwd": n_attn * cuda}
    for counts in per_step:
        assert all(counts[k] == w for k, w in want.items()), (
            f"launches a step {counts}, want {want}")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], (
        f"the loss did not fall: {losses}")
    ms = sum(step_s[1:]) / len(step_s[1:]) * 1e3
    return {"params": model_lib.count_params(model),
            "layers": cfg.num_layers, "batch": B, "seq": S,
            "dtype": cfg.dtype, "lr": TRAIN_LR, "losses": losses,
            "setup_s": setup_s, "first_step_ms": step_s[0] * 1e3,
            "ms_per_step": ms, "tokens_per_s": B * S / (ms / 1e3),
            "launches_per_step": per_step[-1],
            "moe_pairs_dropped": drops, "state_bytes_on_rank": local,
            "state_bytes_unsharded": full,
            "peak_memory_bytes_build": peak_build,
            "peak_memory_bytes_steps": (torch.cuda.max_memory_allocated(dev)
                                        if cuda else None)}


def worker(rank: int, world: int, store: str, spec: str, cpu: bool,
           report: str):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import device_mesh, make_host_mesh
    name, dims = spec.split(":")
    shape = tuple(int(n) for n in dims.split("x"))
    dev = "cpu" if cpu else f"cuda:{rank}"
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=180))
    try:
        devices = (["cpu"] * world if cpu
                   else [f"cuda:{r}" for r in range(world)])
        mesh = device_mesh(make_host_mesh(*shape, devices=devices,
                                          platform=dev.split(":")[0]))
        cfg, B, S = case_config(name, cpu)
        run = parity if name == "tinyllama" else train
        out = {"rank": rank, "device": dev, **run(cfg, B, S, dev, mesh)}
        Path(f"{report}.{rank}").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def run_case(spec: str, cpu: bool) -> dict:
    import torch.multiprocessing as mp

    name, dims = spec.split(":")
    world = int(np.prod([int(n) for n in dims.split("x")]))
    cfg, B, S = case_config(name, cpu)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "rank")
        try:
            mp.spawn(worker, args=(world, os.path.join(tmp, "store"), spec,
                                   cpu, report), nprocs=world, join=True)
            out = {"ok": True, "ranks": [
                json.loads(Path(f"{report}.{r}").read_text())
                for r in range(world)]}
        except Exception:
            out = {"ok": False, "error": traceback.format_exc()[-3000:]}
    return {"case": spec, "arch": cfg.name, "layers": cfg.num_layers,
            "dtype": cfg.dtype, "batch": B, "seq": S, **out,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES))
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU at the reduced widths")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    need = max(int(d) * int(m) for d, m in
               (c.split(":")[1].split("x") for c in args.cases))
    card = "cpu"
    if not args.cpu:
        if torch.cuda.device_count() < need:
            raise SystemExit(f"needs {need} cards, sees "
                             f"{torch.cuda.device_count()}")
        from repro_torch.kernels import build
        build.library()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    results = []
    for c in args.cases:
        results.append(run_case(c, args.cpu))
        print(json.dumps({"case": c, "ok": results[-1]["ok"],
                          "seconds": results[-1]["seconds"]}),
              file=sys.stderr, flush=True)
    text = json.dumps({"card": card, "cases": results})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
