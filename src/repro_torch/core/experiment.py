"""End-to-end Tryage experiment pipeline (the port of
``repro.core.experiment``).

Produces every quantity the paper reports, with artifacts written under
``experiments/tryage_torch/`` (never the JAX package's
``experiments/tryage/``) so later runs can re-read them:

  1. train the 11-expert library on the synthetic Pile (Fig. 2 premise)
  2. build ground-truth Q-tables (per-prompt loss/accuracy per expert)
  3. train the perceptive router on the train Q-table (eq. 2/3)
  4. evaluate: eps loss-prediction error, optimal-selection accuracy vs
     baselines (Fig. 3a), allocation matrix (3b), per-domain accuracy
     (3c/d), latent separation (Fig. 4), Pareto sweep (Fig. 5)

Everything runs on ``device`` (default: the card); the numpy RNGs are
seeded where the reference seeds them, so corpus, batches and Q-table
rows are the reference's.  Weights are drawn from ``torch.Generator``s
and differ from the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import baselines as bl
from repro_torch.core.library import ModelLibrary, paper_library_specs
from repro_torch.core.objective import size_constraint
from repro_torch.core.pareto import pareto_sweep
from repro_torch.core.qtable import build_q_table, mlm_accuracy
from repro_torch.core.router import (RouterConfig, init_router,
                                     predict_losses, router_embed)
from repro_torch.core.training import (map_chunks, train_library,
                                       train_router)
from repro_torch.data.batching import mlm_batch
from repro_torch.data.corpus import DOMAINS, DomainCorpus
from repro_torch.device import resolve_device
from repro_torch.models.model import encode

ART_DIR = str(Path(__file__).resolve().parents[3] / "experiments"
              / "tryage_torch")


@dataclasses.dataclass
class ExperimentConfig:
    vocab: int = 512
    seq: int = 128
    expert_steps: int = 300
    n_train_prompts: int = 3072
    n_val_prompts: int = 384
    n_test_per_domain: int = 96
    router_epochs: int = 10
    router_batch: int = 32
    seed: int = 0


def _eval_batches(corpus, weights, n, seq, seed, batch=64):
    """n prompts as a list of MLM batches with domain labels."""
    rng = np.random.default_rng(seed)
    out = []
    done = 0
    while done < n:
        b = min(batch, n - done)
        toks, labels = corpus.sample_mixture(weights, b, seq, rng)
        mb = mlm_batch(toks, rng, 0.15, corpus.vocab_size)
        mb["domain"] = labels
        out.append(mb)
        done += b
    return out


def _silhouette(X: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette coefficient (quantitative Fig.-4 stand-in)."""
    X = X / (np.linalg.norm(X, axis=1, keepdims=True) + 1e-9)
    D = np.sqrt(np.maximum(
        (X ** 2).sum(1)[:, None] + (X ** 2).sum(1)[None, :]
        - 2 * X @ X.T, 0.0))
    uniq = np.unique(labels)
    s = np.zeros(len(X))
    for i in range(len(X)):
        same = labels == labels[i]
        same[i] = False
        a = D[i, same].mean() if same.any() else 0.0
        b = min(D[i, labels == u].mean() for u in uniq if u != labels[i])
        s[i] = (b - a) / max(a, b, 1e-9)
    return float(s.mean())


def run_experiment(xc: ExperimentConfig = ExperimentConfig(),
                   verbose=True, save=True, device=None,
                   timings: dict | None = None) -> dict:
    """The whole pipeline on ``device``.  With ``timings`` it is filled
    with each stage's wall seconds (``experts``, ``qtables``,
    ``router``, ``evaluate``; each ends in a device sync) and the
    experts' and router's ``TrainLog``s (``expert_logs``,
    ``router_log``)."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    t0 = time.time()
    stage_t = [time.perf_counter()]

    def stage(name):
        sync()
        stage_t.append(time.perf_counter())
        if timings is not None:
            timings[name] = stage_t[-1] - stage_t[-2]

    corpus = DomainCorpus(vocab_size=xc.vocab, seed=xc.seed)
    uniform = {d: 1.0 / len(DOMAINS) for d in DOMAINS}

    # 1. expert library -------------------------------------------------
    library = ModelLibrary(paper_library_specs(vocab=xc.vocab))
    if verbose:
        print(f"[{time.time()-t0:6.0f}s] training {len(library)} experts "
              f"({xc.expert_steps} steps each)", flush=True)
    expert_logs = [] if timings is not None else None
    train_library(library, corpus, steps=xc.expert_steps, seq=xc.seq,
                  seed=xc.seed, verbose=verbose, device=dev,
                  logs=expert_logs)
    stage("experts")

    # 2. Q-tables --------------------------------------------------------
    if verbose:
        print(f"[{time.time()-t0:6.0f}s] building Q-tables", flush=True)
    train_b = _eval_batches(corpus, uniform, xc.n_train_prompts, xc.seq,
                            xc.seed + 101)
    val_b = _eval_batches(corpus, uniform, xc.n_val_prompts, xc.seq,
                          xc.seed + 202)
    # test: balanced per-domain for per-domain metrics
    test_b = []
    for di, d in enumerate(DOMAINS):
        test_b += _eval_batches(corpus, {d: 1.0}, xc.n_test_per_domain,
                                xc.seq, xc.seed + 303 + di)
    q_train = build_q_table(library, train_b, progress=verbose)
    q_val = build_q_table(library, val_b)
    q_test = build_q_table(library, test_b)

    cat = lambda bs, k: np.concatenate([b[k] for b in bs])
    train_data = {"tokens": cat(train_b, "tokens"), "loss": q_train["loss"]}
    val_data = {"tokens": cat(val_b, "tokens"), "loss": q_val["loss"]}
    test_tokens = cat(test_b, "tokens")
    stage("qtables")

    # 3. router ----------------------------------------------------------
    if verbose:
        print(f"[{time.time()-t0:6.0f}s] training router", flush=True)
    rc = RouterConfig(n_models=len(library), vocab_size=xc.vocab)
    rp = init_router(rc, seed=xc.seed + 7, device=dev)
    rp, log = train_router(rp, rc, train_data, val_data,
                           epochs=xc.router_epochs, batch=xc.router_batch,
                           verbose=verbose)
    stage("router")

    # 4. evaluation -------------------------------------------------------
    if verbose:
        print(f"[{time.time()-t0:6.0f}s] evaluating", flush=True)
    pred = map_chunks(lambda t: predict_losses(rp, rc, {"tokens": t}),
                      test_tokens, dev)                    # (N, M)

    eps = float(np.mean(np.abs(pred - q_test["loss"])))
    tryage_choice = pred.argmin(axis=1)
    N = len(test_tokens)

    choices = {
        "tryage": tryage_choice,
        "oracle": bl.oracle_choices(q_test),
        "random": bl.random_router(N, len(library), xc.seed),
        "largest": bl.largest_router(library, N),
        "leaderboard": bl.leaderboard_router(q_train, N),
        "keyword (gorilla-class)": bl.keyword_router(
            test_tokens, corpus, library),
    }
    sel_acc = {k: bl.selection_accuracy(v, q_test) for k, v in choices.items()}
    agg_acc = {k: mlm_accuracy(q_test, v) for k, v in choices.items()}

    # per-domain accuracy: tryage vs each expert (Fig. 3c/d)
    per_domain = {}
    doms = q_test["domain"]
    for di, d in enumerate(DOMAINS):
        m = doms == di
        row = {e.name: float(q_test["acc"][m, mi].mean())
               for mi, e in enumerate(library.experts)}
        idx = np.where(m)[0]
        row["tryage"] = float(q_test["acc"][idx, tryage_choice[idx]].mean())
        per_domain[d] = row

    # allocation matrix (Fig. 3b)
    alloc = np.zeros((len(DOMAINS), len(library)))
    for di in range(len(DOMAINS)):
        m = doms == di
        for mi in range(len(library)):
            alloc[di, mi] = float((tryage_choice[m] == mi).mean())

    # latent separation (Fig. 4)
    embs = map_chunks(lambda t: router_embed(rp, rc, {"tokens": t}),
                      test_tokens, dev)
    rp0 = init_router(rc, seed=xc.seed + 99, device=dev)
    embs0 = map_chunks(lambda t: router_embed(rp0, rc, {"tokens": t}),
                       test_tokens, dev)
    # generalist-expert embedding (GPT-2-analog comparison point)
    gen = library.experts[0]
    embs_gen = map_chunks(lambda t: encode(gen.params, {"tokens": t})
                          .mean(dim=1), test_tokens, dev)
    sil = {"tryage_router": _silhouette(embs, doms),
           "untrained_router": _silhouette(embs0, doms),
           "generalist_lm": _silhouette(embs_gen, doms)}

    # Pareto sweep (Fig. 5)
    pareto = pareto_sweep(pred, q_test, library, size_constraint(library))
    stage("evaluate")

    results = {
        "config": dataclasses.asdict(xc),
        "library": [{"name": e.name, "n_params": e.n_params,
                     "recency": e.recency} for e in library.experts],
        "router_eps": eps,
        "router_val_best": log.best_val,
        "router_stopped_early": log.stopped_early,
        "selection_accuracy": sel_acc,
        "aggregate_accuracy": agg_acc,
        "per_domain": per_domain,
        "allocation": alloc.tolist(),
        "silhouette": sil,
        "pareto": pareto,
        "wall_s": round(time.time() - t0, 1),
    }
    if timings is not None:
        timings["expert_logs"] = expert_logs
        timings["router_log"] = log

    if save:
        os.makedirs(ART_DIR, exist_ok=True)
        with open(os.path.join(ART_DIR, "results.json"), "w") as f:
            json.dump(results, f, indent=1)
        with open(os.path.join(ART_DIR, "artifacts.pkl"), "wb") as f:
            pickle.dump({
                "library": library, "router_params": rp, "rc": rc,
                "q_test": q_test, "q_train": q_train, "pred": pred,
                "test_tokens": test_tokens, "corpus": corpus,
                "train_log": dataclasses.asdict(log),
            }, f)
        if verbose:
            print(f"saved artifacts to {ART_DIR}", flush=True)
    return results


def load_artifacts():
    """The artifacts of the last saved run (the library's and router's
    tensors load on the device they were saved from)."""
    with open(os.path.join(ART_DIR, "artifacts.pkl"), "rb") as f:
        return pickle.load(f)


def load_results():
    with open(os.path.join(ART_DIR, "results.json")) as f:
        return json.load(f)


if __name__ == "__main__":
    import sys
    fast = "--fast" in sys.argv
    xc = ExperimentConfig()
    if fast:
        xc = ExperimentConfig(expert_steps=60, n_train_prompts=512,
                              n_val_prompts=128, n_test_per_domain=24,
                              router_epochs=3)
    res = run_experiment(xc)
    print(json.dumps({k: v for k, v in res.items()
                      if k in ("router_eps", "selection_accuracy",
                               "aggregate_accuracy", "silhouette",
                               "wall_s")}, indent=1))
