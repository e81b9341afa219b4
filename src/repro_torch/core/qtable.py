"""Q-table construction: ground-truth per-prompt expert losses (the
port of ``repro.core.qtable``).

The Oracle router (paper eq. 1) needs L(z, M_i) for every prompt z and
expert M_i.  We compute per-prompt masked-LM loss and masked-token top-1
accuracy by running each expert over the evaluation prompts.  This is the
supervision signal for the predictive router (eq. 2) and the evaluation
target for routing accuracy (paper Fig. 3a).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.library import ModelLibrary
from repro_torch.device import module_device
from repro_torch.models.model import Model, forward


def _per_prompt_metrics(model: Model, batch):
    """Returns (loss (B,), acc (B,)) for an MLM batch of tensors.  The
    argmax takes the first index on ties, as ``jnp.argmax`` does."""
    logits = forward(model, batch, mode="train").float()
    targets, mask = batch["targets"].long(), batch["mask"].float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = mask.sum(-1).clamp_min(1.0)
    loss = nll.sum(-1) / denom
    pred = logits.argmax(-1)
    acc = ((pred == targets).float() * mask).sum(-1) / denom
    return loss, acc


@torch.inference_mode()
def per_prompt_metrics(model: Model, batch: dict):
    """``_per_prompt_metrics`` of a numpy batch on the model's device:
    (loss (B,), acc (B,)) as numpy arrays."""
    dev = module_device(model)
    tb = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
          for k in ("tokens", "targets", "mask")}
    loss, acc = _per_prompt_metrics(model, tb)
    return loss.cpu().numpy(), acc.cpu().numpy()


def build_q_table(library: ModelLibrary, batches: list[dict],
                  progress: bool = False):
    """Run every expert over every batch of prompts.

    batches: list of MLM batches (each {"tokens","targets","mask"}).
    Returns dict with:
      loss (N, n_models), acc (N, n_models), domain (N,)
    """
    losses, accs = [], []
    domains = np.concatenate([b["domain"] for b in batches])
    for e in library.experts:
        el, ea = zip(*(per_prompt_metrics(e.params, b) for b in batches))
        losses.append(np.concatenate(el))
        accs.append(np.concatenate(ea))
        if progress:
            print(f"  qtable: {e.name} mean_loss={np.mean(losses[-1]):.3f} "
                  f"mean_acc={np.mean(accs[-1]):.3f}", flush=True)
    return {
        "loss": np.stack(losses, axis=1),
        "acc": np.stack(accs, axis=1),
        "domain": domains,
    }


def mlm_accuracy(qtable: dict, choices: np.ndarray) -> float:
    """Aggregate MLM accuracy achieved by a routing policy ``choices``."""
    return float(np.mean(qtable["acc"][np.arange(len(choices)), choices]))
