"""End-to-end co-training of router + experts (paper eq. 4/5; the port
of ``repro.core.e2e``).

Each step: (i) the router routes a batch of prompts (eq. 4); (ii) every
selected expert takes a gradient step on the prompts routed to it (eq. 5);
(iii) the router takes a gradient step towards the *freshly measured*
losses of all experts on the batch (eq. 2).  Updates are decoupled, as the
paper prescribes, so experts self-organize (SOM-style) toward the prompt
distribution the router sends them.  The experts' and the router's
weights are trained in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.library import ModelLibrary
from repro_torch.core.qtable import per_prompt_metrics
from repro_torch.core.router import Router, RouterConfig, predict_losses
from repro_torch.core.training import expert_step, router_step, to_device
from repro_torch.data.batching import BatchIterator
from repro_torch.data.corpus import DomainCorpus
from repro_torch.device import module_device
from repro_torch.optim import OptState, adamw_init


@dataclasses.dataclass
class E2EState:
    router_params: Router
    router_opt: OptState
    expert_opts: list
    history: list = dataclasses.field(default_factory=list)


def cotrain(library: ModelLibrary, router_params: Router, rc: RouterConfig,
            corpus: DomainCorpus, *, steps=50, batch=32, seq=128, seed=0,
            router_lr=5e-5, verbose=False) -> E2EState:
    st = E2EState(router_params=router_params,
                  router_opt=adamw_init(router_params),
                  expert_opts=[adamw_init(e.params) for e in library.experts])
    uniform = {d: 1.0 / 8 for d in corpus.tables}
    it = BatchIterator(corpus, uniform, batch, seq, seed=seed)
    dev = module_device(router_params)

    for step_i in range(steps):
        b = next(it)
        tb = to_device(b, dev)
        # (eq. 4) route
        with torch.inference_mode():
            pred = predict_losses(st.router_params, rc,
                                  {"tokens": tb["tokens"]}).cpu().numpy()
        choice = pred.argmin(axis=1)
        # (eq. 5) update each selected expert on its routed prompts
        for mi in np.unique(choice):
            idx = torch.from_numpy(np.where(choice == mi)[0]).to(dev)
            sub = {k: v[idx] for k, v in tb.items()}
            e = library.experts[int(mi)]
            st.expert_opts[mi], _ = expert_step(
                e.params, st.expert_opts[mi], sub, lr=5e-4)
        # (eq. 2) refresh measured losses, update router toward them
        losses = np.stack([per_prompt_metrics(e.params, b)[0]
                           for e in library.experts], axis=1)
        st.router_opt, rl = router_step(
            st.router_params, st.router_opt, rc, tb["tokens"],
            torch.from_numpy(losses).to(dev), lr=router_lr)
        routed_loss = float(losses[np.arange(len(choice)), choice].mean())
        best_loss = float(losses.min(axis=1).mean())
        st.history.append({"step": step_i, "router_loss": float(rl),
                           "routed_loss": routed_loss,
                           "oracle_loss": best_loss})
        if verbose and step_i % 10 == 0:
            print(f"  e2e step {step_i}: router {float(rl):.4f} "
                  f"routed {routed_loss:.3f} oracle {best_loss:.3f}",
                  flush=True)
    return st
