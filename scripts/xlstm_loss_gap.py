#!/usr/bin/env python3
"""How far xlstm's second training loss may sit from the reference's, on
the CPU.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python3 scripts/xlstm_loss_gap.py \
        [--seeds N] [--microbatch M]

For each seed s < N, the reduced ``xlstm_13b`` starts from
``repro.models.model.init_model(PRNGKey(s))`` and takes two AdamW steps
at lr 1e-3 on batch 2 x 16 drawn as ``launch.train.arch_batches`` draws
them, but from ``default_rng(s)`` (s = 0 is the batch
``tests/test_torch_train_step.py`` uses), in four ways:

* the reference's ``build_train_step`` with its chunkwise mLSTM (the
  default form, which the test holds the port against);
* the same with its sequential mLSTM (two sound forms of one function:
  their gap is f32 noise that Adam's first step turns into lr-sized
  moves);
* the port's ``train_step`` on the CPU;
* the port with the mLSTM's q, k and v rounded to bf16 (a control: the
  gap a real loss of precision in the scan gives).

Prints one JSON line a seed with the four pairs of losses and the
relative gaps of the second loss (``port_vs_chunk``, ``seq_vs_chunk``,
``control_vs_chunk``; ``*_step1`` for the first).  A test's tolerance
belongs between the sound gaps and the control's.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import PerfKnobs as JKnobs
from repro.launch.steps import build_train_step
from repro.models import ssm as jssm
from repro.models.common import InputShape
from repro.models.model import init_model as jinit_model
from repro.optim import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch.data.corpus import DomainCorpus
from repro_torch.launch.steps import PerfKnobs, train_step
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw_init
from test_torch_train_step import _host_mesh

LR, B, S = 1e-3, 2, 16


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--microbatch", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(2)
    jcfg = jget_config("xlstm_13b").reduced()
    pcfg = bridge.model_config_from(jcfg)
    corpus = DomainCorpus(vocab_size=pcfg.vocab_size)
    built = {}

    def batches(seed):
        rng = np.random.default_rng(seed)
        uniform = {d: 1.0 / 8 for d in corpus.tables}
        out = []
        for _ in range(2):
            toks, _ = corpus.sample_mixture(uniform, B, S, rng)
            out.append({"tokens": np.clip(toks, 0, pcfg.vocab_size - 1),
                        "mask": np.ones((B, S), np.int32)})
        return out

    def reference(params, bs, impl):
        jssm.MLSTM_DEFAULT_IMPL = impl     # read when the step is traced
        if impl not in built:
            built[impl] = build_train_step(
                jcfg, InputShape(name="t", seq_len=S, global_batch=B,
                                 kind="train"),
                _host_mesh(), JKnobs(donate=False,
                                     microbatch=args.microbatch), lr=LR)
        opt = jadamw_init(params)
        opt = {"step": opt.step, "mu": opt.mu, "nu": opt.nu}
        p, losses = params, []
        with _host_mesh():
            for b in bs:
                p, opt, loss = built[impl].fn(
                    p, opt, {k: jnp.asarray(v) for k, v in b.items()})
                losses.append(float(loss))
        return losses

    scan = tssm.mlstm_chunkwise

    def bf16_scan(q, k, v, i_pre, f_pre, state):
        def r(a):
            return a.bfloat16().float()
        return scan(r(q), r(k), r(v), i_pre, f_pre, state)

    def port(params, bs, control):
        tssm.mlstm_chunkwise = bf16_scan if control else scan
        try:
            model = bridge.model_from_jax(params, pcfg, device="cpu")
            opt = adamw_init(model)
            return [float(train_step(
                model, opt, b, knobs=PerfKnobs(microbatch=args.microbatch),
                lr=LR, device="cpu")) for b in bs]
        finally:
            tssm.mlstm_chunkwise = scan

    def gap(a, b, i=1):
        return abs(a[i] - b[i]) / abs(b[i])

    for seed in range(args.seeds):
        params, _ = jinit_model(jax.random.PRNGKey(seed), jcfg)
        bs = batches(seed)
        chunk = reference(params, bs, "chunkwise")
        seq = reference(params, bs, "sequential")
        ported, control = port(params, bs, False), port(params, bs, True)
        print(json.dumps({
            "seed": seed, "microbatch": args.microbatch,
            "ref_chunkwise": chunk, "ref_sequential": seq, "port": ported,
            "control_bf16": control,
            "port_vs_chunk": gap(ported, chunk),
            "seq_vs_chunk": gap(seq, chunk),
            "control_vs_chunk": gap(control, chunk),
            "port_vs_chunk_step1": gap(ported, chunk, 0),
            "control_vs_chunk_step1": gap(control, chunk, 0)}), flush=True)


if __name__ == "__main__":
    main()
