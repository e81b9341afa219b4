"""The port's training CLI (``repro.launch.train``'s counterpart).

Two modes:
  --arch <id>         train the REDUCED variant of a zoo config
                      (``get_config(arch).reduced()``) on the synthetic
                      corpus for N steps with ``train_step`` at lr 1e-3,
                      on the reference's numpy batches;
  --tryage            run the Tryage pipeline (experts + router):
                      ``core.experiment.run_experiment``.

Both run on the card unless ``--device cpu`` is given; without a card
and without ``--device`` they raise.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --tryage --fast
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def arch_batches(cfg, steps: int, batch: int, seq: int):
    """The reference CLI's batches, one a step, as numpy arrays: a
    uniform mixture of the corpus's domains (seed 0); the encoder, vlm
    and audio families take random-normal ``embeds`` with MLM
    ``targets`` and ``mask`` (and the encoder its masked ``tokens``)."""
    from repro_torch.data.batching import mlm_batch
    from repro_torch.data.corpus import DomainCorpus

    corpus = DomainCorpus(vocab_size=cfg.vocab_size)
    rng = np.random.default_rng(0)
    uniform = {d: 1.0 / 8 for d in corpus.tables}
    for _ in range(steps):
        toks, _lab = corpus.sample_mixture(uniform, batch, seq, rng)
        toks = np.clip(toks, 0, cfg.vocab_size - 1)
        if cfg.is_encoder or cfg.family in ("vlm", "audio"):
            mb = mlm_batch(toks, rng, 0.15, cfg.vocab_size)
            out = {"embeds": rng.standard_normal(
                       (batch, seq, cfg.d_model)).astype(np.float32),
                   "targets": mb["targets"], "mask": mb["mask"]}
            if cfg.family not in ("vlm", "audio"):
                out["tokens"] = mb["tokens"]
        else:
            out = {"tokens": toks, "mask": np.ones((batch, seq), np.int32)}
        yield out


def train_arch(arch: str, steps: int, batch: int, seq: int, device=None,
               verbose=True):
    """Losses of ``steps`` training steps of ``arch``'s reduced config
    (weights drawn from seed 0 on ``device``, default the card)."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import PerfKnobs, train_step
    from repro_torch.models.model import init_model
    from repro_torch.optim import adamw_init

    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = init_model(cfg, seed=0, device=dev)
    opt = adamw_init(model)
    losses = []
    for i, b in enumerate(arch_batches(cfg, steps, batch, seq)):
        loss = float(train_step(model, opt, b, knobs=PerfKnobs(), lr=1e-3,
                                device=dev))
        losses.append(loss)
        if verbose and (i % 5 == 0 or i == steps - 1):
            print(f"  {arch} step {i}: loss {loss:.4f}", flush=True)
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"{arch}: a loss is not finite: {losses}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--tryage", action="store_true")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.tryage:
        from repro_torch.core.experiment import ExperimentConfig, run_experiment
        xc = ExperimentConfig()
        if args.fast:
            xc = ExperimentConfig(expert_steps=60, n_train_prompts=512,
                                  n_val_prompts=128, n_test_per_domain=24,
                                  router_epochs=3)
        return run_experiment(xc, device=args.device)
    if not args.arch:
        ap.error("--arch or --tryage required")
    t0 = time.time()
    losses = train_arch(args.arch, args.steps, args.batch, args.seq,
                        device=args.device)
    print(f"{args.arch}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({time.time()-t0:.0f}s)")
    return losses


if __name__ == "__main__":
    main()
