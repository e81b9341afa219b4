#!/usr/bin/env python3
"""Where ``bench_cascade``'s gate holds: the cascade against single-shot
routing on libraries trained at the experiment configs the reference
uses, on the card, and against the reference on the CPU.

    python3 scripts/cascade_regimes.py [--steps 60,120,300] [--out FILE]
    python3 scripts/cascade_regimes.py --reference [--art-dir DIR] [--out FILE]

On the card (default): for each expert-step count, ``run_experiment``
trains the paper library and router at the reference's config for it
(60: the fast config its cached artifacts hold, ``benchmarks/run.py``
``_results(fast=True)``; 120: the config that bench falls back to
without ``--fast``; 300: the default ``ExperimentConfig``,
``chip_smoke.py``'s ``train_path``) into a temporary directory, and
``launch.gates.cascade`` gives its 13 rows and the gate's verdict; the
run's selection accuracies beside them.  The last library's bench runs
again on a CPU copy of the same weights (with the router's calibrated
uncertainty head copied, not retrained), and the rows that differ are
listed.

``--reference`` (this host's CPU; imports JAX): the port trains the
default config on the CPU (or reads ``--art-dir``'s artifacts when
there), then the reference's ``bench_cascade`` (``benchmarks/run.py``,
loaded by file path) and the port's ``gates.cascade`` run on the same
weights (carried into the JAX package by ``bridge.model_tree`` /
``router_tree``, the uncertainty head calibrated once by the port); and
the JAX package and the port train roberta-analog (the largest expert)
and codebert-analog 300 steps each from the same initial weights and
batches: losses at steps 1, 2, 10, 100, 200, 300, the mean of the last
50, and masked accuracy on one held-out github batch.

Prints one JSON object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# the reference's experiment config for each expert-step count
CONFIGS = {60: {"expert_steps": 60, "n_train_prompts": 512,
                "n_val_prompts": 128, "n_test_per_domain": 24,
                "router_epochs": 3},
           120: {"expert_steps": 120, "n_train_prompts": 1024,
                 "n_val_prompts": 192, "n_test_per_domain": 48,
                 "router_epochs": 5},
           300: {}}
COMPARED = ("roberta-analog", "codebert-analog")


def bench_rows(gen) -> tuple[list, str]:
    """The rows of ``gates.cascade`` (or the reference's bench) and its
    verdict: "dominates", or the refusal's text."""
    rows = []
    try:
        for row in gen:
            rows.append([row[0], float(row[1]), row[2]])
    except RuntimeError as e:
        if "does not dominate" not in str(e):
            raise
        return rows, str(e)
    return rows, "dominates"


def on_card(steps: list[int]) -> dict:
    import torch
    from repro_torch.core import experiment as ex
    from repro_torch.core.training import calibrate_uncertainty
    from repro_torch.launch import gates
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": torch.cuda.get_device_name(0), "regimes": []}
    saved = ex.ART_DIR
    for n in steps:
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="tryage_cascade_")
        try:
            ex.ART_DIR = tmp
            res = ex.run_experiment(ex.ExperimentConfig(**CONFIGS[n]),
                                    verbose=False, save=True, device="cuda")
            art = ex.load_artifacts()
        finally:
            ex.ART_DIR = saved
            shutil.rmtree(tmp, ignore_errors=True)
        router = calibrate_uncertainty(art["router_params"], art["rc"],
                                       art["test_tokens"],
                                       art["q_test"]["loss"])
        rows, verdict = bench_rows(gates.cascade(
            art["library"], router, art["rc"], art["corpus"],
            expert_steps=n, device="cuda"))
        out["regimes"].append({
            "expert_steps": n, "config": res["config"], "rows": rows,
            "verdict": verdict,
            "selection_accuracy": res["selection_accuracy"],
            "seconds": time.perf_counter() - t0})
        print(json.dumps({"expert_steps": n, "verdict": verdict}),
              file=sys.stderr, flush=True)
    lib_cpu = copy.deepcopy(art["library"])
    for e in lib_cpu.experts:
        e.params.cpu()
    cpu_rows, cpu_verdict = bench_rows(gates.cascade(
        lib_cpu, copy.deepcopy(router).cpu(), art["rc"], art["corpus"],
        expert_steps=steps[-1], device="cpu"))
    out["cpu_rerun"] = {"expert_steps": steps[-1], "verdict": cpu_verdict,
                        "differs": [[a, b] for a, b in zip(rows, cpu_rows)
                                    if a != b]}
    return out


def train_both(name: str) -> dict:
    """One paper expert trained 300 steps by the JAX package and by the
    port on the CPU from the same initial weights and batches."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.core.library import paper_library_specs
    from repro.data.batching import BatchIterator
    from repro.data.corpus import DomainCorpus
    from repro.models.model import forward as jforward
    from repro.models.model import init_model, lm_loss
    from repro.optim.adamw import adamw_init, adamw_update
    from repro_torch import bridge
    from repro_torch.core.training import expert_step, to_device
    from repro_torch.models.model import forward
    from repro_torch.optim.adamw import adamw_init as port_adamw_init

    specs = paper_library_specs(512)
    i = [s.name for s in specs].index(name)
    spec = specs[i]
    params, _ = init_model(jax.random.PRNGKey(i), spec.cfg)
    model = bridge.model_from_jax(params, bridge.model_config_from(spec.cfg),
                                  device="cpu")
    opt, port_opt = adamw_init(params), port_adamw_init(model)

    @jax.jit
    def step(p, o, b):
        (loss, _), g = jax.value_and_grad(
            lambda q: lm_loss(q, spec.cfg, b, remat=False), has_aux=True)(p)
        p, o = adamw_update(p, g, o, lr=1e-3, weight_decay=1e-5)
        return p, o, loss

    batches = BatchIterator(DomainCorpus(512, 0), spec.train_mixture, 16,
                            128, seed=i + 1)
    jl, tl = [], []
    for _ in range(300):
        b = next(batches)
        params, opt, loss = step(params, opt, {
            k: jnp.asarray(v) for k, v in b.items() if k != "domain"})
        jl.append(float(loss))
        port_opt, loss = expert_step(model, port_opt, to_device(b, "cpu"),
                                     lr=1e-3)
        tl.append(float(loss))
    b = next(BatchIterator(DomainCorpus(512, 0), {"github": 1.0}, 64, 128,
                           seed=999))
    mask = b["mask"].astype(bool)
    jlog = jforward(params, spec.cfg, {"tokens": jnp.asarray(b["tokens"])},
                    mode="train")
    jlog = np.asarray(jlog[0] if isinstance(jlog, tuple) else jlog)
    with torch.inference_mode():
        tlog = forward(model, {"tokens": torch.from_numpy(b["tokens"])},
                       mode="train").numpy()
    acc = lambda lg: float((lg.argmax(-1)[mask] == b["targets"][mask]).mean())
    at = (0, 1, 9, 99, 199, 299)
    return {"expert": name, "steps_reported": [k + 1 for k in at],
            "loss_reference": [jl[k] for k in at],
            "loss_port": [tl[k] for k in at],
            "mean_last50": [float(np.mean(jl[-50:])),
                            float(np.mean(tl[-50:]))],
            "github_accuracy": [acc(jlog), acc(tlog)]}


def reference(art_dir: str) -> dict:
    import jax
    import torch
    from repro.core import experiment as jex
    from repro.core.library import ModelLibrary as JLibrary
    from repro.core.library import paper_library_specs
    from repro.core.router import RouterConfig as JRouterConfig
    from repro.data.corpus import DomainCorpus
    from repro_torch import bridge
    from repro_torch.core import experiment as ex
    from repro_torch.core.training import calibrate_uncertainty
    from repro_torch.launch import gates

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    ex.ART_DIR = art_dir
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(art_dir, "artifacts.pkl")):
        ex.run_experiment(ex.ExperimentConfig(), verbose=False, save=True,
                          device="cpu")
    train_s = time.perf_counter() - t0
    art = ex.load_artifacts()
    rc = art["rc"]
    router = calibrate_uncertainty(art["router_params"], rc,
                                   art["test_tokens"], art["q_test"]["loss"])
    port, port_verdict = bench_rows(gates.cascade(
        art["library"], router, rc, art["corpus"], expert_steps=300,
        device="cpu"))

    as_jax = lambda tree: jax.tree.map(
        lambda t: jax.numpy.asarray(t.detach().numpy()), tree)
    specs = paper_library_specs(512)
    for spec, e in zip(specs, art["library"].experts):
        spec.params, spec.n_params = as_jax(bridge.model_tree(e.params)), \
            e.n_params
    jart = {"library": JLibrary(specs),
            "router_params": as_jax(bridge.router_tree(router)),
            "rc": JRouterConfig(**{k: getattr(rc, k) for k in (
                "n_models", "vocab_size", "num_layers", "d_model",
                "num_heads", "d_ff", "head_hidden")}),
            "corpus": DomainCorpus(512, 0)}
    jex.load_artifacts = lambda: jart
    spec = importlib.util.spec_from_file_location(
        "reference_benchmarks", ROOT / "benchmarks" / "run.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    ref, ref_verdict = bench_rows(bench.bench_cascade(
        {"config": {"expert_steps": 300}}))
    return {"train_seconds": train_s,
            "port": {"rows": port, "verdict": port_verdict},
            "reference": {"rows": ref, "verdict": ref_verdict},
            "differs": [[a, b] for a, b in zip(port, ref) if a != b],
            "trained_alike": [train_both(n) for n in COMPARED]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default="60,120,300",
                    help="expert-step counts to train on the card")
    ap.add_argument("--reference", action="store_true",
                    help="on the CPU, against the JAX package")
    ap.add_argument("--art-dir", default=str(ROOT / "experiments"
                                             / "cascade_regimes"),
                    help="--reference: where the CPU-trained artifacts go")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.reference:
        out = reference(args.art_dir)
    else:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card (or --reference)")
        out = on_card([int(s) for s in args.steps.split(",")])
    text = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
