#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
and holds each against its plain PyTorch version at its path's shapes.
Then it drives the port's paths, each with the launch counts set to 0
just before it and read just after:

* ``main_path``: 256 requests through ``TryageEngine.run()`` over the
  paper-scale library (11 experts, vocab 512, seeded random weights)
  with the router's uncertainty head and the fused cascade on; the
  answers must match a CPU run of the same engine;
* ``serve_path``: the same library, router and requests through
  ``TryageEngine.serve()`` (continuous batching, ``max_wait_s=10``):
  the decisions and NLL must match ``run()``'s with fewer padded rows;
  then with speculative escalation, with the busiest expert forced down
  and with failures injected into its lane (a health tracker), behind
  the session front end with a queue of 32, through the metrics export,
  and for 64 requests on the CPU;
* ``xlstm_serve``: the full ``xlstm-1.3b`` config (48 layers, 3.43 B
  parameters, bf16, seeded random weights) prefills 4 prompts of 512
  tokens with ``prefill_step`` and greedy-decodes 32 tokens with
  ``serve_step``; ``xlstm_crosscheck`` runs a one-unit f32 copy of it at
  full width on the card and on the CPU and compares them, and holds
  decode against a longer prefill for the whole config in f32;
* ``zoo_serve``: the zoo's other nine configs at full width in bf16
  with seeded weights drawn on the card, one at a time:
  ``prefill_step`` into the KV caches (capacity prompt + steps) and
  Mamba states, then greedy ``serve_step`` decode: tinyllama-1.1b and
  qwen1.5-0.5b (4 x 512, 32 steps), gemma3-4b (2 x 2048, its 1024-slot
  rings roll; 32 steps), starcoder2-15b (1 x 4608, past its 4096
  window; 16 steps), qwen2-vl-72b with 8 of its 80 layers (embeddings 2
  x 1024, 16 token steps), hubert-xlarge (embeddings 4 x 512, an
  encoder: prefill only), qwen2-moe-a2.7b (all 24 layers, 4 x 512, 32
  steps), grok-1-314b with 4 of its 64 layers and jamba-v0.1-52b with
  one 8-layer unit (1 x 2048, 16 steps); one attention launch per
  attention layer a prefill, none in decode; each MoE record gives the
  share of (token, choice) pairs dropped at capacity in the timed
  prefill and decode, the largest expert load over the mean, and one
  MoE layer's time split (routing, experts, the rest: buffer write,
  gather and combine);
* ``zoo_crosscheck``: f32 at full width, reduced depth: tinyllama (4
  layers), gemma3 (one 6-layer unit, a 1100-token prompt), qwen2-moe
  (2 layers) and jamba (2 layers: Mamba with a dense MLP, Mamba with
  MoE) card vs CPU (logits, greedy tokens, each MoE layer's expert sets
  token by token, excused only at a near tie of the router's
  probabilities), and for every decoder (jamba's whole unit too:
  ``mamba_step`` against ``mamba_full``) decode against a prefill one
  token longer on the card, held up to the first MoE layer that drops a
  pair and reported past it, and for jamba again with a capacity factor
  of E / K, where nothing drops, held in full;
* ``attention_grad``: the attention backward kernel against torch
  autograd of the plain version at the training shapes, small causal,
  window, softcap and GQA cases, both sides of the switch between its
  one-launch and two-launch paths (128 keys), hd 128 and a long causal
  window, and the zoo's training shapes in f32 and bf16 (tinyllama,
  gemma3's local and global layers at hd 256 and 2,048 tokens,
  qwen2-moe), and a bit-identical rerun;
* ``mlstm_grad``: the mLSTM backward kernel against torch autograd of
  the chunkwise plain version at xlstm-1.3b's training shape (2 x 512,
  dh 1024), the reduced config's and with a carried state, and a
  bit-identical rerun;
* ``zoo_train``: ``train_step`` in bf16 with remat at full width, 5
  AdamW steps on one fixed batch each: tinyllama-1.1b (22 layers, 4 x
  512), gemma3-4b (34 layers, 1 x 2048), xlstm-1.3b (48 layers, 2 x
  512) and qwen2-moe-a2.7b (4 of its 24 layers: 24 would need about 230
  GB), each loss must fall, each step must launch each backward kernel
  once per such layer, and no plain version may run; ms a step,
  tokens/s, peak memory, a profiled step's busy share, top kernels and
  the backward kernels' shares;
* ``zoo_train_crosscheck``: one f32 training step's loss and gradients
  at full width and reduced depth, card vs a CPU copy of the same
  weights (tinyllama and gemma3 2 layers, xlstm one 8-layer unit,
  qwen2-moe 2 layers);
* ``train_cli``: the training CLI's ``train_arch`` for all ten reduced
  configs on the card, 5 steps each, finite losses;
* ``train_path``: the paper's experiment pipeline (``run_experiment``
  with the default ``ExperimentConfig``: 11 experts of
  ``paper_library_specs(vocab=512)`` trained 300 MLM steps each, the
  Q-tables, the BERT-small router, the baselines and the Pareto sweep)
  on the card, with every expert's and the router's loss required to
  fall, and 3 expert and 3 router steps held card vs CPU;
* ``adapt_path``: ``benchmarks/run.py``'s drift scenario on the trained
  library through ``serve()``, a frozen and an adapting engine, and one
  ``"head"`` and one ``"all"`` online step held card vs CPU.
* ``cache_tiers``: ``benchmarks/run.py``'s ``bench_cache`` at full size
  on the trained library (11 experts, seq 128): 96 unique prompts, 64
  exact repeats and 96 paraphrases through a fresh-scoring oracle, the
  exact tier alone, every tier (a ``DiskKVStore`` plus the semantic
  tier at an eps calibrated on the card's embeddings) and a restart
  over the same directory: against the oracle, no wrong routing from
  the exact tiers or a fresh score (near ties excused), the semantic
  tier's wrong routings counted and listed; the restart answers from T1
  and T2 with the tiered run's verdicts; no stale version; and the
  tiered engine's routing rerun on the CPU gives the same choice and
  tier per row;
* ``serve_cli``: ``python -m repro_torch.launch.serve``'s ``main`` three
  times: every tier under 600 req/s Poisson arrivals over 4 sessions,
  the same again as a restart over the same directory (answered from
  T2), and the FIFO drain with the exact tier.

It checks that every kernel of each path was launched in that path's
run, and times each kernel beside its bound; the router heads also at
every bucket size the path launches them at, beside the launch floor
(the device time of an empty kernel, ``csrc/launch_floor.cu``), and
attention also at the zoo decoders' bf16 prefill shapes beside SDPA.  Each
phase prints one JSON line; the line before the last is the card's
name and power limit from ``nvidia-smi``, the last is ``{"ok": true,
"device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result.
Without a CUDA card, or outside a checkout, it exits non-zero at once.

TF32 is off throughout for PyTorch's own products (it flips near-tie
argmins); the attention kernels (forward and backward) and the mLSTM
scan run theirs on the tensor cores in 3xTF32, which keeps f32
accuracy (bf16 attention inputs, exact in TF32, take one pass for
q k^T and two for P V).  Times: CUDA events over
back-to-back calls after a warm-up, and the profiler's device time per
kernel.  Bounds: the larger of the bytes each call must move over 3.35
TB/s and its f32 operations over 67 TFLOP/s (H100 SXM data sheet); for
the tensor-core kernels also the larger of the bytes and three times the
operations over the TF32 tensor-core rate, 495 TFLOP/s (``bound_tc_ms``);
for bf16 attention the operations over the bf16 rate, 989 TFLOP/s.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_TC_FLOPS_PER_S = 495e12   # dense TF32 tensor cores; 3xTF32 takes 3 passes
BF16_TC_FLOPS_PER_S = 989e12   # dense bf16 tensor cores
CHOICE_GAP = 1e-5          # a choice may differ only below this top-two gap
ROUTER_TOL = 1e-5          # router heads: pred / sigma vs the plain version
ATTN_TOL = 2e-5            # attention: online vs full softmax summation order
NLL_ATOL = 1e-4            # card vs CPU engine, per-request masked NLL
# mLSTM scan: max abs err of h, C1, n1, m1 each within this share of the
# reference's largest magnitude (f32 sums of up to 1024 terms in another
# order, and h divides by a running denominator)
MLSTM_REL_TOL = 1e-4
# xLSTM cross-check, card (kernel) vs CPU (plain), f32 at full width:
# logits and every state leaf within this share of the CPU's largest
# magnitude (8 layers of GEMMs summed in other orders); greedy tokens
# may differ only where the CPU's top-two logit gap is under TOKEN_GAP
XLSTM_REL_TOL = 1e-3
TOKEN_GAP = 1e-4
# decode one token from a prefill's state vs a prefill one token longer
# (tests/test_models_smoke.py's tolerance)
DECODE_ATOL, DECODE_RTOL = 2e-2, 1e-2
# through all 48 random layers, decode vs prefill logits may differ by at
# most this many times the change one ulp of the first block's input makes
# (the two paths round differently in every layer, not in the first only,
# and each layer's difference is amplified by the layers after it; a wrong
# state or chunk gives a gap of the logits' own size)
ROUNDING_FACTOR = 10.0
# attention backward vs torch autograd of the plain version: each of dQ,
# dK, dV within this share of its largest magnitude (f32 sums over up to
# 128 keys and 8 query heads in another order)
ATTN_GRAD_REL_TOL = 1e-4
ATTN_GRAD_CASES = [  # (B, S, T, H, KV, hd, causal, window, softcap)
    (16, 128, 128, 8, 8, 32, False, 0, 0.0),   # roberta-analog
    (16, 128, 128, 4, 4, 40, False, 0, 0.0),   # the d=160 specialists
    (32, 128, 128, 4, 4, 32, False, 0, 0.0),   # router, "all" adaptation
    (2, 77, 77, 4, 2, 16, True, 0, 0.0),
    (2, 50, 50, 4, 4, 24, True, 9, 0.0),
    (2, 64, 64, 6, 2, 32, False, 0, 5.0),
    (1, 40, 40, 2, 1, 128, True, 7, 3.0),
    (1, 20, 8, 2, 2, 8, False, 3, 0.0),        # rows that see no key
    # the backward's two paths meet at 128 keys: one launch up to it,
    # two launches (row sums and dQ, then dK/dV) past it
    (2, 96, 128, 4, 2, 40, False, 0, 0.0),
    (2, 96, 129, 4, 2, 40, False, 0, 2.0),
    (2, 128, 128, 4, 4, 128, False, 0, 0.0),   # hd 128, one launch
    (1, 300, 300, 2, 1, 64, True, 64, 0.0),    # long T, causal window
    (1, 300, 140, 2, 2, 8, False, 3, 0.0),     # long T, rows with no key
]
# the attention backward at the zoo's training shapes (zoo_train), in
# bf16 and f32: (B, S, H, KV, hd, causal, window, label); bf16 is held
# within one bf16 ulp of the plain f32 gradient rounded, plus
# ATTN_GRAD_REL_TOL of the largest
ZOO_ATTN_GRAD = [(4, 512, 32, 4, 64, True, 0, "tinyllama-1.1b"),
                 (1, 2048, 8, 4, 256, True, 1024, "gemma3-4b local"),
                 (1, 2048, 8, 4, 256, True, 0, "gemma3-4b global"),
                 (4, 512, 16, 16, 128, True, 0, "qwen2-moe-a2.7b")]
# the mLSTM backward against autograd of the chunkwise plain version:
# (B, S, H, dh, carried state); xlstm-1.3b's training shape, the reduced
# config's (d 256: dh 256) and a carried state (the kernel takes one; no
# gradient flows into it)
MLSTM_GRAD_CASES = [(2, 512, 4, 1024, False), (2, 128, 2, 256, False),
                    (2, 96, 2, 32, True)]
MLSTM_GRAD_REL_TOL = 1e-4
# zoo_train: (arch, fields cut, batch, seq), full width in bf16, remat on,
# TRAIN_STEPS AdamW steps (lr ZOO_TRAIN_LR) on one fixed batch; only
# qwen2-moe is cut (24 layers would need about 230 GB: bf16 weights and
# gradients and f32 moments)
ZOO_TRAIN = [("tinyllama-1.1b", None, 4, 512),
             ("gemma3-4b", None, 1, 2048),
             ("xlstm-1.3b", None, 2, 512),
             ("qwen2-moe-a2.7b", {"num_layers": 4}, 4, 512)]
TRAIN_STEPS = 5
# the reference CLI's lr: bf16 weights of ~1/sqrt(d) move at it
ZOO_TRAIN_LR = 1e-3
# zoo_train_crosscheck, f32 at full width: (arch, layers, batch, seq);
# xlstm keeps one 8-layer unit (7 mLSTM, 1 sLSTM)
ZOO_TRAIN_CROSS = [("tinyllama-1.1b", 2, 2, 128), ("gemma3-4b", 2, 1, 128),
                   ("xlstm-1.3b", 8, 1, 128), ("qwen2-moe-a2.7b", 2, 2, 128)]
TRAIN_CROSS_LOSS_RTOL, TRAIN_CROSS_GRAD_REL = 1e-4, 1e-3
# a leaf whose card-vs-CPU gap passes TRAIN_CROSS_GRAD_REL is held
# instead to TRAIN_ROUNDING_FACTOR times its own one-ulp sensitivity (the
# CPU gradient's move when the first block's input moves by one ulp),
# where that sensitivity is at least a tenth of TRAIN_CROSS_GRAD_REL:
# random xLSTM layers amplify rounding past the gate.  On an H100 the 14
# xlstm leaves past the gate read 0.91-1.18 times their sensitivity
# (largest gap 1.55e-3 against 1.70e-3), so 3 leaves room for one more
# draw's spread and none for an error of a few ulps more
TRAIN_ROUNDING_FACTOR = 3.0
# an MoE token that chose other experts on the card at a near tie changes
# every gradient downstream and upstream of it: the step is drawn again
# from the next token seed, up to this many draws, until no route differs
TRAIN_CROSS_DRAWS = 3
# train_cli: the reference CLI's batch and sequence, TRAIN_STEPS steps
CLI_TRAIN_BATCH, CLI_TRAIN_SEQ = 8, 128
# the zoo's attention at its prefill shapes: (B, S, H, KV, hd, causal,
# window, softcap, dtype); S past the window where there is one
ZOO_ATTN_CASES = [
    (4, 512, 32, 4, 64, True, 0, 0.0, "bfloat16"),        # tinyllama
    (4, 512, 16, 16, 64, True, 0, 0.0, "bfloat16"),       # qwen1.5-0.5b
    (2, 2048, 8, 4, 256, True, 1024, 0.0, "bfloat16"),    # gemma3 local
    (2, 2048, 8, 4, 256, True, 0, 0.0, "bfloat16"),       # gemma3 global
    (1, 4608, 48, 4, 128, True, 4096, 0.0, "bfloat16"),   # starcoder2
    (2, 1024, 64, 8, 128, True, 0, 0.0, "bfloat16"),      # qwen2-vl
    (4, 512, 16, 16, 80, False, 0, 0.0, "bfloat16"),      # hubert
    (2, 256, 8, 4, 128, False, 0, 30.0, "bfloat16"),      # softcap
    (4, 512, 16, 16, 128, True, 0, 0.0, "bfloat16"),      # qwen2-moe
    (1, 2048, 48, 8, 128, True, 0, 30.0, "bfloat16"),     # grok-1
    (1, 2048, 32, 8, 128, True, 0, 0.0, "bfloat16"),      # jamba
    (1, 1100, 8, 4, 256, True, 1024, 0.0, "float32"),     # gemma3 in f32
    (1, 1100, 8, 4, 256, True, 0, 0.0, "float32"),
]
# training card vs CPU from the same weights: 3 steps' losses and the
# first step's gradients to this relative error (the weights after 3 Adam
# steps are held to Adam's reach instead: see card_vs_cpu_training)
TRAIN_REL_TOL = 1e-4
TRAIN_BATCH = 16                   # train_expert's batch
STAGES = ("experts", "qtables", "router", "evaluate")
# one online step card vs CPU: "head" (the loss head from one embedding
# pass) and "all" (through the encoder and the attention backward)
ADAPT_HEAD_TOL, ADAPT_ALL_TOL = 1e-5, 1e-4
DRIFT_TOL = 0.5    # bench_drift: "routed well" = within 0.5 nats of best
XLSTM_ARCH, XLSTM_B, XLSTM_S, XLSTM_DECODE = "xlstm-1.3b", 4, 512, 32
# zoo_serve: (arch, fields cut, batch, prompt, decode steps), full width
# in bf16; depth is cut where the bf16 weights do not fit in 80 GB:
# qwen2-vl (145 GB at 80 layers), grok-1 (9.8 GB a layer) and jamba (104
# GB; one 8-layer unit: 7 Mamba, 1 attention, 4 MoE layers); hubert is
# an encoder (prefill only)
ZOO_SERVE = [("tinyllama-1.1b", None, 4, 512, 32),
             ("qwen1.5-0.5b", None, 4, 512, 32),
             ("gemma3-4b", None, 2, 2048, 32),
             ("starcoder2-15b", None, 1, 4608, 16),
             ("qwen2-vl-72b", {"num_layers": 8}, 2, 1024, 16),
             ("hubert-xlarge", None, 4, 512, 0),
             ("qwen2-moe-a2.7b", None, 4, 512, 32),
             ("grok-1-314b", {"num_layers": 4}, 1, 2048, 16),
             ("jamba-v0.1-52b", {"num_layers": 8}, 1, 2048, 16)]
# zoo_crosscheck, f32 at full width: card vs CPU (arch, layers, prompt,
# greedy tokens; jamba's 2 layers are a Mamba layer with a dense MLP and
# one with MoE), and decode vs a prefill one longer on the card (arch,
# layers, batch, prompt; gemma3 and starcoder2 past their windows,
# jamba's whole unit)
ZOO_CROSS = [("tinyllama-1.1b", 4, 128, 8), ("gemma3-4b", 6, 1100, 8),
             ("qwen2-moe-a2.7b", 2, 128, 8), ("jamba-v0.1-52b", 2, 128, 8)]
# an MoE layer's expert set may differ card vs CPU only where the CPU's
# router probabilities at the K-th and (K+1)-th choice are this close
ROUTE_GAP = 1e-5
# times: the decoders' attention at their bf16 prefill shapes (B, S, H,
# KV, hd, causal, window, softcap, config)
ZOO_TIMES = [(4, 512, 32, 4, 64, True, 0, 0.0, "tinyllama-1.1b"),
             (2, 2048, 8, 4, 256, True, 1024, 0.0, "gemma3-4b local"),
             (2, 2048, 8, 4, 256, True, 0, 0.0, "gemma3-4b global"),
             (1, 4608, 48, 4, 128, True, 4096, 0.0, "starcoder2-15b"),
             (4, 512, 16, 16, 128, True, 0, 0.0, "qwen2-moe-a2.7b"),
             (1, 2048, 48, 8, 128, True, 0, 30.0, "grok-1-314b"),
             (1, 2048, 32, 8, 128, True, 0, 0.0, "jamba-v0.1-52b")]
# (arch, layers, batch, prompt, MoE capacity factor: None for the
# config's; jamba also at E / K, where C = T and nothing drops, so its
# whole unit is held)
ZOO_DVP = [("tinyllama-1.1b", 4, 2, 128, None),
           ("qwen1.5-0.5b", 4, 2, 128, None),
           ("gemma3-4b", 6, 1, 1100, None),
           ("starcoder2-15b", 2, 1, 4200, None),
           ("qwen2-vl-72b", 2, 1, 128, None),
           ("jamba-v0.1-52b", 8, 2, 128, None),
           ("jamba-v0.1-52b", 8, 2, 128, 8.0)]
CROSS_S, CROSS_DECODE = 128, 8

# the README's flag phrases; 192 unique prompts repeat with the same flags
FLAG_TEXTS = ["", "[Flag: Prefer small]", "[Flag: Smallest model]",
              "[Flag: Newest model]", "[Flag: Best model]",
              "[Flag: Small model] [Flag: Recent model]"]
N_REQUESTS, N_UNIQUE, SEQ, MAX_BATCH = 256, 192, 128, 32
# cache_tiers: bench_cache's stream at full size; serve_cli: the arrival
# rate of its runs A and B, about half serve()'s closed-loop rate
CT_UNIQUE, CT_REPEAT, CT_PARA = 96, 64, 96
CLI_RATE = 600.0
OUT_DIR = ROOT / "chiprun_out"

# name: (source, the TPU kernel it replaces, the name its device
# functions carry in ptxas, cuobjdump and the profiler)
SOURCES = {
    "router_score": ("src/repro_torch/kernels/csrc/router_score.cu",
                     "src/repro/kernels/router_score/kernel.py:24",
                     "router_score_kernel"),
    "router_cascade": ("src/repro_torch/kernels/csrc/router_cascade.cu",
                       "src/repro/kernels/router_cascade/kernel.py:48",
                       "router_cascade_kernel"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:25",
                        "flash_attention_kernel"),
    # no Pallas counterpart: the gradient of the kernel above, which the
    # JAX package takes by XLA autodiff of attend_full(impl="xla")
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:120", "flash_attention_bwd"),
    "mlstm_scan": ("src/repro_torch/kernels/csrc/mlstm_scan.cu",
                   "src/repro/kernels/mlstm_scan/kernel.py:36",
                   "mlstm_scan"),
    # no Pallas counterpart: the gradient of the scan above, which the
    # JAX package takes by XLA autodiff of _mlstm_cell_chunkwise
    "mlstm_scan_bwd": ("src/repro_torch/kernels/csrc/mlstm_scan_bwd.cu",
                       "src/repro/models/ssm.py:254", "mlstm_bwd_"),
}
ROUTER_PATH = ("router_score", "router_cascade", "flash_attention")
# kernels whose products run on the tensor cores (3xTF32; bf16 attention
# in one or two TF32 passes): name -> the functions that must hold TF32
# HMMA ("" every one).  The mLSTM backward's small launches (gates, den,
# dS, the sums, the outputs) run on the CUDA cores in f32; its products
# all run in mlstm_bwd_gemm.
TENSOR_CORE = {"flash_attention": "", "flash_attention_bwd": "",
               "mlstm_scan": "", "mlstm_scan_bwd": "mlstm_bwd_gemm"}


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``at_s``: seconds since the script began."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T0}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------ phase 1-2

def device_phase(torch) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32}}
    emit("device", **info)
    return info


def sass_mma(build, lib) -> dict:
    """Per device function of the built library: how many tensor-core
    instructions (HMMA) its SASS holds, and which kinds, from
    ``cuobjdump -sass`` of each object file (all at once; one pass over
    the whole library takes a minute)."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    objs = sorted(build.objects_dir(lib.path).glob("*.o")) or [lib.path]
    procs = [subprocess.Popen([str(cuobjdump), "-sass", str(o)],
                              stdout=subprocess.PIPE, text=True)
             for o in objs]
    out = {}
    for proc in procs:
        text, _ = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"cuobjdump failed ({proc.args})")
        cur = None
        for line in text.splitlines():
            if "Function :" in line:
                cur = out.setdefault(line.split("Function :")[1].strip(),
                                     {"hmma": 0, "kinds": []})
            elif cur is not None and "HMMA" in line:
                cur["hmma"] += 1
                kind = line[line.index("HMMA"):].split()[0]
                if kind not in cur["kinds"]:
                    cur["kinds"].append(kind)
    return out


def build_phase() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.library()
    ptxas = build.ptxas_summary(lib.ptxas_log)
    sass = sass_mma(build, lib)
    kernels = {}
    for name, (_, _, entry) in SOURCES.items():
        # a kernel may be several device functions (template instances,
        # or launches): every one must build without spilling
        funcs = {fn: info for fn, info in ptxas.items() if entry in fn}
        check(bool(funcs), f"ptxas reported nothing for {entry}")
        for fn, info in funcs.items():
            check(info.get("spill_stores", 0) == 0
                  and info.get("spill_loads", 0) == 0,
                  f"{fn} spills registers: {info}")
            if name in TENSOR_CORE:
                mma = sass.get(fn, {"hmma": 0, "kinds": []})
                check((mma["hmma"] > 0 or TENSOR_CORE[name] not in fn)
                      and all("TF32" in k for k in mma["kinds"]),
                      f"{fn}: no TF32 tensor-core instructions in its SASS "
                      f"({mma})")
                info = {**info, "sass_hmma": mma["hmma"],
                        "sass_hmma_kinds": mma["kinds"]}
            kernels.setdefault(name, {})[fn] = info
    emit("build", library=str(lib.path.relative_to(ROOT)),
         nvcc_seconds=lib.build_seconds,
         load_seconds=time.perf_counter() - t0, kernels=kernels)


# -------------------------------------------------------------- phase 3

def head_inputs(torch, B, M=11, d=128, hh=128, n_c=2, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, device="cuda",
                                          generator=g) * scale
    t = {"emb": r(B, d), "w1": r(d, hh, scale=d ** -0.5),
         "b1": r(hh, scale=0.1), "w2": r(hh, M, scale=hh ** -0.5),
         "b2": r(M, scale=0.1), "uw1": r(d, hh, scale=d ** -0.5),
         "ub1": r(hh, scale=0.1), "uw2": r(hh, M, scale=hh ** -0.5),
         "ub2": r(M, scale=0.1), "cvals": r(n_c, M).abs(),
         "lam": r(B, n_c).abs()}
    t["ladder"] = torch.randperm(M, device="cuda", generator=g).to(
        torch.int32)
    return t


SCORE_ARGS = ("emb", "w1", "b1", "w2", "b2", "cvals", "lam")
CASCADE_ARGS = ("emb", "w1", "b1", "w2", "b2", "uw1", "ub1", "uw2", "ub2",
                "cvals", "lam", "ladder")


def choice_diffs(torch, got, want, combined):
    """(rows whose choice differs, of those the rows whose top-two gap
    of the constrained score is under CHOICE_GAP)."""
    diff = (got != want).nonzero().flatten()
    top2 = combined.topk(2, dim=1, largest=False).values
    near = (top2[:, 1] - top2[:, 0] < CHOICE_GAP)
    return int(diff.numel()), int(near[diff].sum())


def parity_phase(torch) -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm_scan import ops as ml_ops
    from repro_torch.kernels.router_cascade import ops as rc_ops
    from repro_torch.kernels.router_score import ops as rs_ops
    err = {name: 0.0 for name in SOURCES}
    cases = []
    for B in (1, 3, 32, 37):
        t = head_inputs(torch, B, seed=B)
        pred, choice = rs_ops.router_score_fused(*(t[k] for k in SCORE_ARGS))
        cpred, sigma, cchoice, esc = rc_ops.router_score_cascade_fused(
            *(t[k] for k in CASCADE_ARGS))
        torch.cuda.synchronize()
        ppred, pchoice = rs_ops.router_score_plain(*(t[k] for k in SCORE_ARGS))
        qpred, qsigma, qchoice, qesc = rc_ops.router_cascade_plain(
            *(t[k] for k in CASCADE_ARGS))
        combined = ppred + t["lam"] @ t["cvals"]
        e_s = float((pred - ppred).abs().max())
        e_c = max(float((cpred - qpred).abs().max()),
                  float((sigma - qsigma).abs().max()))
        d_s, n_s = choice_diffs(torch, choice, pchoice, combined)
        d_c, n_c = choice_diffs(torch, cchoice, qchoice, combined)
        # an escalation target may differ only between near-tied experts
        rows = ((esc != qesc) & (cchoice == qchoice)).nonzero().flatten()
        gap = (combined[rows, esc[rows].long()]
               - combined[rows, qesc[rows].long()]).abs()
        d_e, n_e = int(rows.numel()), int((gap < CHOICE_GAP).sum())
        check(e_s <= ROUTER_TOL and e_c <= ROUTER_TOL,
              f"router heads at B={B}: max abs err {e_s}, {e_c}")
        check(d_s == n_s and d_c == n_c and d_e == n_e,
              f"router choices at B={B}: {d_s}/{d_c} differ, {n_s}/{n_c} "
              f"near ties; {d_e} escalation targets differ, {n_e} near ties")
        err["router_score"] = max(err["router_score"], e_s)
        err["router_cascade"] = max(err["router_cascade"], e_c)
        cases.append({"kernel": "router", "B": B, "err_score": e_s,
                      "err_cascade": e_c, "choice_diff": [d_s, d_c],
                      "near_tie_rows": [n_s, n_c], "esc_diff": [d_e, n_e]})
    attn_cases = [(32, 4, 32, False, 0, 0.0), (32, 4, 40, False, 0, 0.0),
                  (32, 8, 32, False, 0, 0.0), (32, 8, 40, False, 0, 0.0),
                  (4, 4, 40, True, 32, 30.0)]
    for B, H, hd, causal, window, softcap in attn_cases:
        g = torch.Generator(device="cuda").manual_seed(H * hd)
        q, k, v = (torch.randn(B, 128, H, hd, device="cuda", generator=g)
                   for _ in range(3))
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        torch.cuda.synchronize()
        ref = fa_ops.attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        e = float((out - ref).abs().max())
        check(e <= ATTN_TOL, f"flash_attention B={B} H={H} hd={hd}: "
                             f"max abs err {e}")
        err["flash_attention"] = max(err["flash_attention"], e)
        cases.append({"kernel": "flash_attention", "BH": B * H, "S": 128,
                      "hd": hd, "causal": causal, "window": window,
                      "softcap": softcap, "max_abs_err": e})
    # the zoo's prefill shapes (bf16, hd 64-256, GQA, windows with S past
    # them) and f32 at hd 256: within one bf16 ulp of each element plus
    # ATTN_TOL (the kernel's f32 result is within it of the plain
    # version's before each rounds to bf16); f32 within ATTN_TOL
    err["flash_attention_bf16_ulps"] = 0.0
    for (B, S, H, KV, hd, causal, window, softcap,
         dtype) in ZOO_ATTN_CASES:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(S + hd)
        q = torch.randn(B, S, H, hd, device="cuda", generator=g).to(dt)
        k, v = (torch.randn(B, S, KV, hd, device="cuda",
                            generator=g).to(dt) for _ in range(2))
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        torch.cuda.synchronize()
        ref = fa_ops.attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        check(out.dtype == dt, f"flash_attention {dtype} wrote {out.dtype}")
        diff = (out.float() - ref.float()).abs()
        e = float(diff.max())
        case = {"kernel": "flash_attention", "dtype": dtype, "B": B, "S": S,
                "H": H, "KV": KV, "hd": hd, "causal": causal,
                "window": window, "softcap": softcap, "max_abs_err": e}
        if dt == torch.bfloat16:
            ulp = bf16_ulp(torch, torch.maximum(out.float().abs(),
                                                ref.float().abs()))
            ulps = float(((diff - ATTN_TOL).clamp_min(0) / ulp).max())
            check(ulps <= 1.0, f"flash_attention bf16 {case}: {ulps} ulps "
                               f"past {ATTN_TOL}")
            case["max_ulps_past_tol"] = ulps
            err["flash_attention_bf16_ulps"] = max(
                err["flash_attention_bf16_ulps"], ulps)
        else:
            check(e <= ATTN_TOL, f"flash_attention f32 {case}: max abs err "
                                 f"{e}")
            err["flash_attention"] = max(err["flash_attention"], e)
        cases.append(case)
        del q, k, v, out, ref, diff
    for B, S, H, dh, carried in ((1, 64, 1, 16, False), (2, 96, 2, 64, True),
                                 (XLSTM_B, XLSTM_S, 4, 1024, False)):
        args = mlstm_inputs(torch, B, S, H, dh, carried, seed=S + dh)
        h, st = ml_ops.mlstm_chunkwise(*args)
        torch.cuda.synchronize()
        refs = {"chunkwise": ml_ops.mlstm_chunkwise_plain(*args)}
        if S * dh <= 96 * 64:
            refs["sequential"] = ml_ops.mlstm_sequential(*args)
        case = {"kernel": "mlstm_scan", "B": B, "S": S, "H": H, "dh": dh,
                "carried_state": carried}
        for rname, (rh, rst) in refs.items():
            for leaf, got, want in (("h", h, rh), ("C", st["C"], rst["C"]),
                                    ("n", st["n"], rst["n"]),
                                    ("m", st["m"], rst["m"])):
                e, scale = float((got - want).abs().max()), float(
                    want.abs().max())
                check(bool(torch.isfinite(got).all())
                      and e <= MLSTM_REL_TOL * scale,
                      f"mlstm_scan {case} {leaf} vs {rname}: max abs err "
                      f"{e}, reference max {scale}")
                case[f"{leaf}_vs_{rname}"] = [e, scale]
                err["mlstm_scan"] = max(err["mlstm_scan"], e)
        cases.append(case)
    emit("parity", tolerances={"router": ROUTER_TOL, "attention": ATTN_TOL,
                               "attention_bf16": "1 bf16 ulp + attention",
                               "choice_gap": CHOICE_GAP,
                               "mlstm_rel_to_max": MLSTM_REL_TOL},
         max_abs_err=err, cases=cases)
    return err


def bf16_ulp(torch, x):
    """One bf16 unit in the last place of each element of ``x`` (f32)."""
    return torch.exp2(torch.floor(torch.log2(x.clamp_min(2.0 ** -126))) - 7)


def mlstm_inputs(torch, B, S, H, dh, carried, seed):
    """q, k, v, i, f, state for the mLSTM scan: normal q/k/v and input
    gates, forget gates biased by +3 as the model's ``b_if`` is; a
    carried state is small and random, else zeros."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    q, k, v = r(B, S, H, dh), r(B, S, H, dh), r(B, S, H, dh)
    i_pre, f_pre = r(B, S, H), r(B, S, H) + 3.0
    if carried:
        state = {"C": r(B, H, dh, dh) * 0.3, "n": r(B, H, dh) * 0.3,
                 "m": r(B, H)}
    else:
        state = {"C": torch.zeros(B, H, dh, dh, device="cuda"),
                 "n": torch.zeros(B, H, dh, device="cuda"),
                 "m": torch.zeros(B, H, device="cuda")}
    return q, k, v, i_pre, f_pre, state


# -------------------------------------------------------------- phase 4

def make_requests(Request, parse_flags, mb, thr):
    """256 requests: prompt i % 192, the flag text i % 6, and a
    confidence floor on the admission batches 1 and 5 (a quarter)."""
    reqs = []
    for i in range(N_REQUESTS):
        j = i % N_UNIQUE
        cascade = (i // MAX_BATCH) % 4 == 1
        reqs.append(Request(uid=i, tokens=mb["tokens"][j],
                            targets=mb["targets"][j], mask=mb["mask"][j],
                            lambdas=parse_flags(FLAG_TEXTS[i % len(FLAG_TEXTS)]),
                            min_confidence=thr if cascade else 0.0))
    return reqs


@contextlib.contextmanager
def batch_sizes(module, fn_name: str):
    """Within the block, count the batch sizes (the first argument's
    first dimension) passed to ``module.fn_name``, the name its callers
    reach, in a dict batch size -> calls.  The wrapper itself and its
    launch count are untouched."""
    inner, hist = getattr(module, fn_name), {}

    def counted(x, *args, **kwargs):
        hist[x.shape[0]] = hist.get(x.shape[0], 0) + 1
        return inner(x, *args, **kwargs)

    setattr(module, fn_name, counted)
    try:
        yield hist
    finally:
        setattr(module, fn_name, inner)


def main_setup(torch):
    """What ``main_path`` and ``serve_path`` share: the paper-scale
    library and router with seeded random weights on the card, their
    copies on the CPU, the constraints, the prompts and the cascade
    threshold.  ``requests()`` makes the 256 requests anew."""
    from types import SimpleNamespace

    from repro_torch.core import objective
    from repro_torch.core.library import ModelLibrary, paper_library_specs
    from repro_torch.core.router import (RouterConfig, init_router,
                                         predict_losses, predict_uncertainty)
    from repro_torch.data.batching import mlm_batch
    from repro_torch.data.corpus import DOMAINS, DomainCorpus
    from repro_torch.models.model import count_params, init_model
    from repro_torch.serving import Request, lambda_matrix, parse_flags

    t_setup = time.perf_counter()
    lib = ModelLibrary(paper_library_specs(vocab=512))
    for i, e in enumerate(lib.experts):
        e.params = init_model(e.cfg, seed=100 + i, device="cuda")
        e.n_params = count_params(e.params)
    rc = RouterConfig(n_models=len(lib), vocab_size=512)
    router = init_router(rc, seed=7, uncertainty=True, device="cuda")
    cons = [objective.size_constraint(lib), objective.recency_constraint(lib)]
    corpus = DomainCorpus(vocab_size=512, seed=0)
    rng = np.random.default_rng(0)
    toks, _ = corpus.sample_mixture({d: 1.0 for d in DOMAINS}, N_UNIQUE, SEQ,
                                    rng)
    mb = mlm_batch(toks, rng, 0.15, 512)

    # threshold: the median confidence of the cascade rows' first picks,
    # so some rows escalate and some do not
    probe = make_requests(Request, parse_flags, mb, 1.0)
    casc = [r for r in probe if r.min_confidence > 0]
    with torch.inference_mode():
        tk = torch.from_numpy(np.stack([r.tokens for r in casc])).cuda()
        pred = predict_losses(router, rc, {"tokens": tk}).cpu().numpy()
        sigma = predict_uncertainty(router, rc, {"tokens": tk}).cpu().numpy()
    cnames = [c.name for c in cons]
    cmat = objective.constraint_matrix(cons, len(lib))
    scores = pred + lambda_matrix(casc, cnames) @ cmat
    first = scores.argmin(1)
    conf = objective.confidence_scores(sigma)[np.arange(len(casc)), first]
    thr = float(np.median(conf))
    lib_cpu = copy.deepcopy(lib)
    for e in lib_cpu.experts:
        e.params.cpu()
    return SimpleNamespace(
        lib=lib, router=router, rc=rc, cons=cons, cnames=cnames, cmat=cmat,
        thr=thr, lib_cpu=lib_cpu, router_cpu=copy.deepcopy(router).cpu(),
        requests=lambda: make_requests(Request, parse_flags, mb, thr),
        setup_s=time.perf_counter() - t_setup)


def near_tie(s, req, result) -> bool:
    """Whether the CPU ``result`` for ``req`` lies within CHOICE_GAP of
    another choice: its top-two constrained scores, or its confidence
    and the threshold."""
    from repro_torch.serving import lambda_matrix
    sc = np.sort(result.pred_losses
                 + lambda_matrix([req], s.cnames)[0] @ s.cmat)
    return (sc[1] - sc[0] < CHOICE_GAP
            or abs(result.confidence - s.thr) < CHOICE_GAP)


def main_path_phase(torch, s) -> tuple[dict, dict]:
    """256 requests through ``run()``; returns (the phase's line, the
    Results by uid)."""
    from repro_torch.kernels import launches
    from repro_torch.kernels.router_cascade import ops as rc_ops
    from repro_torch.kernels.router_score import ops as rs_ops
    from repro_torch.models import attention
    from repro_torch.serving import TryageEngine

    lib, router, thr = s.lib, s.router, s.thr

    def engine(library, rtr, device):
        return TryageEngine(library, rtr, s.rc, s.cons, max_batch=MAX_BATCH,
                            fused_cascade=True, device=device)

    def serve(eng, reqs):
        for r in reqs:
            eng.submit(r)
        return {r.uid: r for r in eng.run()}

    serve(engine(lib, router, "cuda"), s.requests())          # warm-up
    torch.cuda.synchronize()
    eng = engine(lib, router, "cuda")
    reqs = s.requests()
    torch.cuda.reset_peak_memory_stats()
    launches.reset_launch_counts()
    with batch_sizes(attention, "flash_attention") as batch_hist, \
            batch_sizes(rs_ops, "router_route") as score_hist, \
            batch_sizes(rc_ops, "router_route_cascade") as cascade_hist:
        t0 = time.perf_counter()
        res = serve(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launches.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check(sorted(res) == list(range(N_REQUESTS)), "not one Result per request")
    for name in ROUTER_PATH:
        check(counts[name] > 0,
              f"kernel {name} was not launched on the main path")
    for r in res.values():
        check(r.loss is not None and np.isfinite(r.loss)
              and 0.0 <= r.accuracy <= 1.0, f"uid {r.uid}: bad loss/accuracy")
        check(r.predictions.shape == (SEQ,)
              and r.pred_losses.shape == (len(lib),)
              and np.isfinite(r.pred_losses).all(), f"uid {r.uid}: bad shape")
    n_casc = sum(r.min_confidence > 0 for r in reqs)
    esc = eng.stats.escalations
    check(0 < esc < n_casc, f"{esc} of {n_casc} cascade rows escalated")

    # one more run under the profiler: where the device time goes
    profile = device_profile(torch, lambda: serve(
        engine(lib, router, "cuda"), s.requests()), wall * 1e3,
        match={name: SOURCES[name][2] for name in ROUTER_PATH})

    # the first 64 requests (one single-shot batch, one cascade batch)
    # again, on the CPU with the same weights through the plain versions
    cpu = serve(engine(s.lib_cpu, s.router_cpu, "cpu"), s.requests()[:64])
    mismatched, excused = cpu_mismatches(s, reqs, res, cpu)
    out = {"requests": N_REQUESTS, "wall_s": wall,
           "req_per_s": N_REQUESTS / wall, "setup_s": s.setup_s,
           "peak_memory_bytes": peak, "launches": counts,
           "threshold": thr, "cascade_rows": n_casc, "escalations": esc,
           "attention_batch_hist": dict(sorted(batch_hist.items())),
           "router_batch_hist": {
               "router_score": dict(sorted(score_hist.items())),
               "router_cascade": dict(sorted(cascade_hist.items()))},
           "router_tiles": eng.stats.router_tiles,
           "depth_hist": {int(k): v for k, v in
                          sorted(eng.stats.cascade_depth_hist.items())},
           "router_time_s": eng.stats.router_time_s,
           "expert_time_s": eng.stats.expert_time_s,
           "profiled_run": profile,
           "cache_hits": eng.stats.cache_hits,
           "router_batches": eng.stats.router_batches,
           "padded_rows": eng.stats.padded_rows,
           "bucket_hits": {int(k): v for k, v in
                           sorted(eng.stats.bucket_hits.items())},
           "per_expert": dict(eng.stats.per_expert),
           "mean_loss": float(np.mean([r.loss for r in res.values()])),
           "cpu_rerun": {"requests": len(cpu), "mismatched": mismatched,
                         "near_tie_excused": excused}}
    emit("main_path", **out)
    return out, res


def cpu_mismatches(s, reqs, card, cpu) -> tuple[list, int]:
    """Hold the card's Results against the CPU's by uid: the same expert
    and depth with NLL within NLL_ATOL, or a near tie on the CPU.
    Returns (the uids that differ, how many of them are near ties)."""
    mismatched, excused = [], 0
    for uid, c in cpu.items():
        g = card[uid]
        if (g.expert, g.cascade_depth) == (c.expert, c.cascade_depth):
            check(abs(g.loss - c.loss) <= NLL_ATOL,
                  f"uid {uid}: NLL {g.loss} on the card, {c.loss} on CPU")
            continue
        excused += near_tie(s, reqs[uid], c)
        mismatched.append(uid)
    check(len(mismatched) == excused,
          f"card and CPU engines disagree on uids {mismatched}")
    return mismatched, excused


def serve_path_phase(torch, s, run_res: dict, run_line: dict,
                     card: str) -> dict:
    """``serve()`` over ``main_path``'s library, router, threshold and
    256 requests: timed against ``run()``, then with speculation, a
    health tracker (an expert forced down; failures injected through
    ``engine.scheduler``), the session front end, the metrics export,
    and a CPU rerun of the first 64 requests."""
    from repro_torch.kernels import launches
    from repro_torch.models import attention
    from repro_torch.serving import (ExpertHealth, ServingFrontend, Session,
                                     TryageEngine, metric_names, render)

    names = [e.name for e in s.lib.experts]

    def engine(lib=s.lib, router=s.router, device="cuda", **kw):
        return TryageEngine(lib, router, s.rc, s.cons, max_batch=MAX_BATCH,
                            fused_cascade=True, max_wait_s=10.0,
                            device=device, **kw)

    def once(results, what, n=N_REQUESTS):
        check(sorted(r.uid for r in results) == list(range(n)),
              f"{what}: not one Result per request")
        return {r.uid: r for r in results}

    # 1. serve(), timed, after a warm-up (benchmarks/run.py:bench_scheduler's
    #    max_wait_s), against main_path's run() on the same requests
    list(engine().serve(iter(s.requests())))
    torch.cuda.synchronize()
    eng = engine()
    torch.cuda.reset_peak_memory_stats()
    launches.reset_launch_counts()
    with batch_sizes(attention, "flash_attention") as batch_hist:
        t0 = time.perf_counter()
        res = once(list(eng.serve(iter(s.requests()))), "serve()")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launches.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ROUTER_PATH:
        check(counts[name] > 0, f"kernel {name} was not launched by serve()")
    nll_err = 0.0
    for uid, r in res.items():
        ref = run_res[uid]
        check((r.expert, r.cascade_depth) == (ref.expert, ref.cascade_depth),
              f"uid {uid}: serve() chose {r.expert}@{r.cascade_depth}, "
              f"run() {ref.expert}@{ref.cascade_depth}")
        check(r.loss is not None and np.isfinite(r.loss),
              f"uid {uid}: bad loss")
        nll_err = max(nll_err, abs(r.loss - ref.loss))
    check(nll_err <= NLL_ATOL, f"serve() NLL {nll_err} from run()'s")
    st = eng.stats
    run_padded = run_line["padded_rows"]
    check(st.padded_rows < run_padded,
          f"serve() padded {st.padded_rows} rows, run() {run_padded}")
    profile = device_profile(torch, lambda: list(engine().serve(
        iter(s.requests()))), wall * 1e3,
        match={name: SOURCES[name][2] for name in ROUTER_PATH})
    hot = max(st.per_expert, key=st.per_expert.get)
    hot_idx = names.index(hot)

    # 2. speculative escalation: the same decisions, every verdict once
    spec = engine(speculate=True)
    spec_res = once(list(spec.serve(iter(s.requests()))), "speculate")
    for uid, r in spec_res.items():
        check((r.expert, r.cascade_depth)
              == (res[uid].expert, res[uid].cascade_depth),
              f"uid {uid}: speculation changed the decision")
    sp = spec.stats
    check(sp.spec_launched > 0, "nothing was speculated")
    check(sp.spec_launched == sp.spec_hits + sp.spec_cancelled
          + sp.spec_wasted, "speculation accounting does not balance")

    # 3. health: the busiest expert forced down, then failures injected
    down = ExpertHealth(len(s.lib), now_fn=lambda: 0.0)
    down.force_down(hot_idx)
    fb = engine(health=down)
    fb_res = once(list(fb.serve(iter(s.requests()))), "force_down")
    check(all(r.expert != hot for r in fb_res.values()),
          f"a Result names the forced-down {hot}")
    check(fb.stats.fallbacks > 0, "no route-time fallback")
    health = ExpertHealth(len(s.lib), now_fn=lambda: 0.0)
    inj = engine(health=health, fallback_max_depth=2)

    def arrivals():
        for i, r in enumerate(s.requests()):
            if i == 0:
                inj.scheduler.inject_failures(hot_idx, 2)
            yield r

    inj_res = once(list(inj.serve(arrivals())), "inject_failures")
    check(inj.stats.reroutes > 0 and inj.stats.failed == 0,
          f"{inj.stats.reroutes} re-routes, {inj.stats.failed} failed")

    # 4. the front end: 4 sessions of 64 requests, a queue of 32
    fe_eng = engine()
    reqs = s.requests()
    for r in reqs:
        r.priority = r.uid % 3
    fe = ServingFrontend(fe_eng, [Session(f"s{k}", reqs[k::4])
                                  for k in range(4)], capacity=32)
    answered = [r.uid for r in fe.serve()]
    check(fe_eng.stats.shed > 0, "the front end shed nothing")
    check(not set(answered) & set(fe.shed_uids)
          and sorted(answered + fe.shed_uids) == list(range(N_REQUESTS)),
          "answered and shed uids do not partition the requests")

    # 5. the metrics export of step 3's injected run
    text = render(inj.stats, health, names)
    for name in metric_names():
        check(text.count(f"# TYPE {name} ") == 1, f"metric {name}")
    check(f"tryage_requests_served_total {len(inj_res)}\n" in text,
          "tryage_requests_served_total is not the Results served")

    # 6. the first 64 requests through serve() on the CPU
    cpu = once(list(engine(s.lib_cpu, s.router_cpu, "cpu").serve(
        iter(s.requests()[:64]))), "CPU serve()", 64)
    mismatched, excused = cpu_mismatches(s, s.requests(), res, cpu)

    out = {"card": card, "requests": N_REQUESTS, "wall_s": wall,
           "req_per_s": N_REQUESTS / wall,
           "run_req_per_s": run_line["req_per_s"],
           "padded_rows": st.padded_rows, "run_padded_rows": run_padded,
           "flushes": dict(st.flushes), "lane_peaks": st.lane_peaks,
           "latency": st.latency_percentiles(),
           "bucket_hits": {int(k): v for k, v in
                           sorted(st.bucket_hits.items())},
           "run_bucket_hits": run_line["bucket_hits"],
           "attention_batch_hist": dict(sorted(batch_hist.items())),
           "launches": counts, "peak_memory_bytes": peak,
           "router_batches": st.router_batches,
           "router_time_s": st.router_time_s,
           "expert_time_s": st.expert_time_s,
           "nll_max_abs_err_vs_run": nll_err,
           "profiled_serve": profile,
           "speculation": {"launched": sp.spec_launched,
                           "hits": sp.spec_hits,
                           "cancelled": sp.spec_cancelled,
                           "wasted": sp.spec_wasted},
           "force_down": {"expert": hot, "fallbacks": fb.stats.fallbacks,
                          "degraded": fb.stats.degraded},
           "inject_failures": {"expert": hot, "reroutes": inj.stats.reroutes,
                               "failed": inj.stats.failed,
                               "expert_failures":
                                   dict(inj.stats.expert_failures)},
           "frontend": {"sessions": 4, "capacity": 32,
                        "admitted": fe_eng.stats.admitted,
                        "shed": fe_eng.stats.shed,
                        "shed_by_priority":
                            dict(fe_eng.stats.shed_by_priority),
                        "queue_peak": fe_eng.stats.admission_queue_peak},
           "metrics_series": len(metric_names()),
           "cpu_rerun": {"requests": len(cpu), "mismatched": mismatched,
                         "near_tie_excused": excused}}
    emit("serve_path", **out)
    return out


# ------------------------------------------------------------ phase 4b

def xlstm_prompts(corpus, B: int, S: int, seed: int = 0):
    """B prompts of S tokens from the port's ``DomainCorpus``, uniform
    over its domains, as ``repro/launch/train.py`` draws them."""
    vocab = corpus.vocab_size
    rng = np.random.default_rng(seed)
    uniform = {d: 1.0 / len(corpus.tables) for d in corpus.tables}
    toks, _ = corpus.sample_mixture(uniform, B, S, rng)
    return np.clip(toks, 0, vocab - 1)


def greedy(torch, model, tokens, steps, device, kernel="mlstm_scan"):
    """prefill_step, then ``steps`` serve_step calls.  Returns (last
    prefill logits, generated tokens (B, steps + 1), per-step decode
    logits, final state, ``kernel``'s launches in the prefill, in the
    decode)."""
    from repro_torch.kernels import launches
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models import model as model_lib
    S = tokens.shape[1]
    launches.reset_launch_counts()
    last, state = prefill_step(model, {"tokens": tokens},
                               cache_capacity=S + steps + 1, device=device)
    n_prefill = launches.launch_counts()[kernel]
    tok = last.argmax(-1).to(torch.int32)[:, None]
    out, dec_logits = [tok], []
    with torch.inference_mode():
        for t in range(steps):
            # the step's logits, for the checks; serve_step returns tokens
            lg, _ = model_lib.decode_step(model, {"tokens": tok}, state, S + t)
            dec_logits.append(lg.float())
            tok, state = serve_step(model, state, tok, S + t, device=device)
            out.append(tok)
    n_decode = launches.launch_counts()[kernel] - n_prefill
    return last, torch.cat(out, 1), dec_logits, state, n_prefill, n_decode


def first_token_diff(torch, toks_g, toks_c, logits_c):
    """(the first step whose card and CPU tokens differ, or None; whether
    at every row that differs there the CPU's top-two logit gap is under
    TOKEN_GAP).  After a differing token the rest follow other inputs."""
    for t in range(toks_c.shape[1]):
        rows = (toks_g[:, t].cpu() != toks_c[:, t]).nonzero().flatten()
        if rows.numel():
            top2 = logits_c[t][rows].topk(2, dim=-1).values
            return t, bool((top2[:, 0] - top2[:, 1] < TOKEN_GAP).all())
    return None, False


def layer_times(torch, model, fn) -> dict:
    """Host seconds per block kind over one call of ``fn``, with a
    device sync around every layer (forward hooks): where a prefill or
    decode step spends its time, layer kind by layer kind."""
    acc: dict = {}
    t0 = {}

    def pre(block, args, kwargs):
        torch.cuda.synchronize()
        t0[block] = time.perf_counter()

    def post(block, args, kwargs, out):
        torch.cuda.synchronize()
        acc[block.kind] = acc.get(block.kind, 0.0) + (
            time.perf_counter() - t0[block])

    hooks = [h for b in model.layers for h in (
        b.register_forward_pre_hook(pre, with_kwargs=True),
        b.register_forward_hook(post, with_kwargs=True))]
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        acc["total"] = time.perf_counter() - t
    finally:
        for h in hooks:
            h.remove()
    return {k: v * 1e3 for k, v in acc.items()}


def xlstm_serve_phase(torch):
    """Returns (the phase's line, the corpus it drew prompts from)."""
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import DomainCorpus
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models import model as model_lib

    cfg = get_config(XLSTM_ARCH)
    n_mlstm = cfg.num_units * cfg.layer_pattern.count("mlstm")
    t_setup = time.perf_counter()
    corpus = DomainCorpus(vocab_size=cfg.vocab_size)
    corpus_s = time.perf_counter() - t_setup
    model = model_lib.init_model(cfg, seed=0, device="cuda")
    n_params = model_lib.count_params(model)
    prompts = torch.from_numpy(xlstm_prompts(corpus, XLSTM_B, XLSTM_S)).cuda()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup

    # warm-up: one prefill and two decode steps
    _, st = prefill_step(model, {"tokens": prompts})
    tok = prompts[:, -1:]
    for t in range(2):
        tok, st = serve_step(model, st, tok, XLSTM_S + t)
    del st
    torch.cuda.synchronize()

    from repro_torch.kernels import launches
    torch.cuda.reset_peak_memory_stats()
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    last, state = prefill_step(model, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts_prefill = launches.launch_counts()
    tok = last.argmax(-1).to(torch.int32)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for t in range(XLSTM_DECODE):
        tok, state = serve_step(model, state, tok, XLSTM_S + t)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = launches.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    generated = torch.cat(generated, 1)

    check(n_params == 3_426_709_840, f"xlstm-1.3b has {n_params} parameters")
    check(bool(torch.isfinite(last).all()), "non-finite prefill logits")
    check(counts_prefill["mlstm_scan"] == n_mlstm,
          f"{counts_prefill['mlstm_scan']} mlstm_scan launches in the "
          f"prefill, want {n_mlstm}")
    check(counts["mlstm_scan"] == n_mlstm, "mlstm_scan launched in decode")
    check(all(bool(torch.isfinite(s["m"]).all()) for s in state),
          "a layer's stabiliser m is not finite")
    check(generated.shape == (XLSTM_B, XLSTM_DECODE + 1)
          and bool(((generated >= 0) & (generated < cfg.vocab_size)).all()),
          "bad generated tokens")

    # decode vs a prefill one longer, beside the model's own sensitivity
    # to one rounding (printed, not gated: bf16 through 48 random layers)
    dvp = decode_vs_prefill(torch, model, prompts, jitter=True)
    check(dvp["finite"], "non-finite decode logits")

    # where the time goes: per layer kind (synced), and the profiler
    with torch.inference_mode():
        by_kind_prefill = layer_times(
            torch, model, lambda: model_lib.prefill(model, {"tokens": prompts}))
        _, st = model_lib.prefill(model, {"tokens": prompts})
        by_kind_decode = layer_times(
            torch, model, lambda: model_lib.decode_step(
                model, {"tokens": tok}, st, XLSTM_S))
    prof_prefill = device_profile(
        torch, lambda: prefill_step(model, {"tokens": prompts}),
        prefill_s * 1e3, match={"mlstm_scan": SOURCES["mlstm_scan"][2]})
    prof_decode = device_profile(
        torch, lambda: serve_step(model, st, tok, XLSTM_S),
        decode_s * 1e3 / XLSTM_DECODE)
    del model, state, st
    torch.cuda.empty_cache()

    out = {"arch": XLSTM_ARCH, "layers": cfg.num_layers,
           "params": n_params, "dtype": cfg.dtype, "batch": XLSTM_B,
           "prompt_len": XLSTM_S, "decode_steps": XLSTM_DECODE,
           "setup_s": setup_s, "corpus_s": corpus_s,
           "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": XLSTM_B * XLSTM_S / prefill_s,
           "decode_ms_per_step": decode_s * 1e3 / XLSTM_DECODE,
           "decode_tokens_per_s": XLSTM_B * XLSTM_DECODE / decode_s,
           "peak_memory_bytes": peak, "launches": counts,
           "decode_vs_prefill_max_logit_gap_bf16": dvp["max_abs_err"],
           "prefill_logit_max_abs_bf16": dvp["logit_max_abs"],
           "one_ulp_logit_change_bf16": dvp["one_ulp_logit_change"],
           "decode_vs_prefill_layer_err_bf16": dvp["layer_err"],
           "layer_ms_prefill": by_kind_prefill,
           "layer_ms_decode_step": by_kind_decode,
           "profiled_prefill": prof_prefill,
           "profiled_decode_step": prof_decode,
           "first_tokens": generated[:, :8].cpu().tolist()}
    emit("xlstm_serve", **out)
    return out, corpus


def ulp_jitter(torch, x, seed=0):
    """``x`` with each non-zero element's magnitude moved one unit in
    the last place up or down (seeded): a change of the size of one
    rounding."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]
    g = torch.Generator(x.device).manual_seed(seed)
    step = torch.randint(0, 2, x.shape, generator=g, device=x.device,
                         dtype=ints) * 2 - 1
    moved = (x.contiguous().view(ints) + step).view(x.dtype)
    return torch.where(x == 0, x, moved)


def last_hidden(torch, model, fn, jitter=False):
    """(``fn()``, each block's output at the last position).  With
    ``jitter`` the first block's input goes through ``ulp_jitter``."""
    outs = []
    hooks = [b.register_forward_hook(
        lambda block, args, out: outs.append(out[0][:, -1].float()))
        for b in model.layers]
    if jitter:
        hooks.append(model.layers[0].register_forward_pre_hook(
            lambda block, args: (ulp_jitter(torch, args[0]),) + args[1:]))
    try:
        with torch.inference_mode():
            return fn(), outs
    finally:
        for h in hooks:
            h.remove()


def decode_vs_prefill(torch, model, prompt, jitter=False):
    """Decode the greedy next token from a prefill's state against a
    prefill over the prompt and that token, layer by layer at that
    position.  Returns {"max_abs_err" (logits), "logit_max_abs",
    "close" (logits at DECODE_ATOL/RTOL), "layer_err",
    "layers_close"}; with ``jitter`` also "one_ulp_logit_change": how
    far that longer prefill's logits move when the first block's input
    moves by one ulp (``ulp_jitter``), the model's own sensitivity to
    rounding."""
    from repro_torch.models import model as model_lib
    S = prompt.shape[1]
    with torch.inference_mode():
        logits, st = model_lib.prefill(model, {"tokens": prompt},
                                       cache_capacity=S + 1)
    tok = logits[:, -1:].argmax(-1)
    del logits
    dec, dec_h = last_hidden(torch, model, lambda: model_lib.decode_step(
        model, {"tokens": tok}, st, S)[0].float())
    del st
    toks = torch.cat([prompt, tok], 1)
    full, full_h = last_hidden(torch, model, lambda: model_lib.prefill(
        model, {"tokens": toks})[0][:, S].float())
    out = {"max_abs_err": float((dec - full).abs().max()),
           "logit_max_abs": float(full.abs().max()),
           "finite": bool(torch.isfinite(dec).all()),
           "close": torch.allclose(dec, full, atol=DECODE_ATOL,
                                   rtol=DECODE_RTOL),
           "layer_err": [float((a - b).abs().max())
                         for a, b in zip(dec_h, full_h)],
           "layers_close": [torch.allclose(a, b, atol=DECODE_ATOL,
                                           rtol=DECODE_RTOL)
                            for a, b in zip(dec_h, full_h)]}
    if jitter:
        moved, _ = last_hidden(torch, model, lambda: model_lib.prefill(
            model, {"tokens": toks})[0][:, S].float(), jitter=True)
        out["one_ulp_logit_change"] = float((moved - full).abs().max())
    return out


def xlstm_crosscheck_phase(torch, corpus) -> dict:
    """A one-unit (8-layer) f32 copy of the config at full width: the
    card (mLSTM kernel) against the CPU (plain versions) on the same
    weights, and on the card decode against prefill; then decode against
    prefill for the whole 48-layer config in f32 on the card.  The
    weights are drawn on the card, where truncated normals are quick,
    and the 8-layer copy is deep-copied to the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = dataclasses.replace(get_config(XLSTM_ARCH),
                              num_layers=len(get_config(XLSTM_ARCH)
                                             .layer_pattern),
                              dtype="float32")
    t0 = time.perf_counter()
    gpu = model_lib.init_model(cfg, seed=1, device="cuda")
    cpu = copy.deepcopy(gpu).cpu()
    setup_s = time.perf_counter() - t0
    prompt = torch.from_numpy(xlstm_prompts(corpus, 1, CROSS_S, seed=1))
    res = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, None)):
        t0 = time.perf_counter()
        res[name] = greedy(torch, model, prompt.to(dev or "cuda"),
                           CROSS_DECODE - 1, dev)
        res[name + "_s"] = time.perf_counter() - t0
    last_c, toks_c, dec_c, st_c, pre_c, _ = res["cpu"]
    last_g, toks_g, dec_g, st_g, pre_g, dcd_g = res["cuda"]
    n_mlstm = cfg.layer_pattern.count("mlstm")
    check(pre_c == 0 and (pre_g, dcd_g) == (n_mlstm, 0),
          f"mlstm_scan launches: cpu {pre_c}, card {pre_g} + {dcd_g}")

    def rel(got, want):
        return float((got.cpu().float() - want.float()).abs().max()) / max(
            float(want.abs().max()), 1e-30)

    e_logits = rel(last_g, last_c)
    check(e_logits <= XLSTM_REL_TOL, f"prefill logits: rel err {e_logits}")
    e_state = 0.0
    for i, (sg, sc) in enumerate(zip(st_g, st_c)):
        for leaf in sc:
            e = rel(sg[leaf], sc[leaf])
            check(e <= XLSTM_REL_TOL, f"layer {i} state {leaf}: rel err {e}")
            e_state = max(e_state, e)
    # tokens: identical, or first differing where the CPU's top-two
    # logit gap is under TOKEN_GAP (the rest then follow other inputs)
    first_diff, excused = first_token_diff(torch, toks_g, toks_c,
                                           [last_c] + dec_c)
    check(first_diff is None or excused,
          f"card and CPU tokens differ at step {first_diff}")

    # on the card: decode one token vs a prefill over S + 1 tokens
    unit = decode_vs_prefill(torch, gpu, prompt.cuda())
    check(unit["close"], f"decode vs prefill on the card: max abs err "
          f"{unit['max_abs_err']}")
    n_params = model_lib.count_params(gpu)
    del cpu, gpu
    torch.cuda.empty_cache()

    # the same for the whole config in f32 on xlstm_serve's prompts, whose
    # S + 1 = 513 tokens run in chunks of 57, not 64.  Through 48 random
    # layers a one-ulp change of the input already moves the logits by
    # more than the JAX test's tolerance, so the first unit is held to
    # that tolerance layer by layer, and the logits to ROUNDING_FACTOR
    # times the model's own one-ulp sensitivity.
    model = model_lib.init_model(dataclasses.replace(
        get_config(XLSTM_ARCH), dtype="float32"), seed=0, device="cuda")
    prompts = torch.from_numpy(xlstm_prompts(corpus, XLSTM_B, XLSTM_S)).cuda()
    deep = decode_vs_prefill(torch, model, prompts, jitter=True)
    del model
    torch.cuda.empty_cache()
    n_unit = len(cfg.layer_pattern)
    out = {"layers": cfg.num_layers, "d_model": cfg.d_model, "dtype": "f32",
           "params": n_params, "batch": 1,
           "prompt_len": CROSS_S, "tokens": CROSS_DECODE, "setup_s": setup_s,
           "cpu_s": res["cpu_s"], "card_s": res["cuda_s"],
           "launches_prefill": pre_g, "launches_decode": dcd_g,
           "logits_rel_err": e_logits, "state_rel_err": e_state,
           "tokens_identical": first_diff is None,
           "first_token_diff": first_diff,
           "decode_vs_prefill_max_abs_err": unit["max_abs_err"],
           "full_depth_f32": {
               "layers": len(deep["layer_err"]), "batch": XLSTM_B,
               "prompt_len": XLSTM_S,
               "decode_vs_prefill_max_abs_err": deep["max_abs_err"],
               "prefill_logit_max_abs": deep["logit_max_abs"],
               "one_ulp_logit_change": deep["one_ulp_logit_change"],
               "layer_err": deep["layer_err"]},
           "tolerances": {"rel_to_max": XLSTM_REL_TOL,
                          "token_gap": TOKEN_GAP,
                          "decode_atol": DECODE_ATOL,
                          "decode_rtol": DECODE_RTOL,
                          "rounding_factor": ROUNDING_FACTOR}}
    emit("xlstm_crosscheck", **out)
    check(all(deep["layers_close"][:n_unit]),
          f"decode vs prefill, first unit of the f32 config: max abs err by "
          f"layer {deep['layer_err'][:n_unit]}")
    check(deep["max_abs_err"] <= ROUNDING_FACTOR *
          deep["one_ulp_logit_change"],
          f"decode vs prefill of the f32 config: logits {deep['max_abs_err']}"
          f", one ulp moves them {deep['one_ulp_logit_change']}")
    return out


# ------------------------------------------------------ phase 4a (the zoo)

def zoo_tokens(torch, cfg, B, S, seed):
    """Token ids uniform over the vocab, seeded, drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                         generator=g, dtype=torch.int32)


def zoo_inputs(torch, cfg, B, S, seed):
    """A prefill batch on the card: token ids, or for the modality stubs
    embeddings with the embedding table's scale (seeded)."""
    from repro_torch.launch import specs
    if not specs.takes_embeds(cfg):
        return {"tokens": zoo_tokens(torch, cfg, B, S, seed)}
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"embeds": (torch.randn(B, S, cfg.d_model, device="cuda",
                                   generator=g) * cfg.d_model ** -0.5)
            .to(cfg.torch_dtype)}


def attn_layers(cfg) -> list:
    """The indices of a config's attention layers."""
    pat = cfg.layer_pattern
    return [i for i in range(cfg.num_layers) if pat[i % len(pat)] == "attn"]


@contextlib.contextmanager
def moe_inputs(model):
    """Record every MoE layer's input while active: a list of (layer
    index, (B, S, d) tensor) in call order."""
    seen = []
    hooks = [b["mlp"].register_forward_hook(
        lambda mod, args, out, i=i: seen.append((i, args[0])))
        for i, b in enumerate(model.layers) if b.use_moe]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def moe_routes(torch, model, seen) -> list:
    """``moe.route`` of each recorded input: (layer index, Routing)."""
    from repro_torch.models import moe
    cfg = model.cfg
    with torch.inference_mode():
        return [(i, moe.route(model.layers[i]["mlp"],
                              x.reshape(-1, cfg.d_model), cfg))
                for i, x in seen]


def moe_stats(torch, model, seen) -> dict:
    """Over the recorded MoE calls: the share of (token, choice) pairs
    dropped at capacity, and each call's largest expert load over the
    mean load (max and mean over the calls); with at most 32 calls (a
    prefill) also each call's dropped pairs and load."""
    E = model.cfg.moe.num_experts
    drops, loads, pairs = [], [], 0
    for _, r in moe_routes(torch, model, seen):
        drops.append(int((~r.keep).sum()))
        pairs += r.keep.numel()
        counts = torch.bincount(r.gate_idx.flatten(), minlength=E).float()
        loads.append(float(counts.max() / counts.mean()))
    dropped = sum(drops)
    by_call = ({"dropped_by_call": drops, "load_by_call": loads}
               if len(loads) <= 32 else {})
    return {"calls": len(loads), "pairs": pairs, "dropped": dropped,
            **by_call, "dropped_share": dropped / pairs if pairs else None,
            "max_load_over_mean": max(loads) if loads else None,
            "mean_max_load_over_mean": (sum(loads) / len(loads)
                                        if loads else None)}


def mean_cosine(torch, x) -> float:
    """The mean cosine between the rows of each batch element of x (B,
    S, d), over the pairs of distinct rows: how far a layer's inputs
    point one way, which concentrates a router's choices."""
    u = x.float() / x.float().norm(dim=-1, keepdim=True)
    S = u.shape[1]
    total = (u @ u.transpose(1, 2)).sum() - u.shape[0] * S
    return float(total / (u.shape[0] * S * (S - 1)))


def moe_breakdown(torch, model, layer, x) -> dict:
    """One MoE layer at a recorded prefill input: device time per call
    (the profiler's, over 10 calls) of the whole layer; of the routing
    alone (softmax, the top-k sort, the argsort by expert, positions,
    aux); of the experts' batched products on a buffer of the call's
    (E, C, d); and of the shared experts.  The rest of the layer is the
    dispatch's buffer write (index_put) and the gather and combine of
    the outputs.  Device times, not events: the routing's small kernels
    are host-bound alone but queue behind the products in the layer.
    None where the profiler traces no device time."""
    import torch.nn.functional as F
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_mlp
    cfg = model.cfg
    p = model.layers[layer]["mlp"]
    xt = x.reshape(-1, cfg.d_model)
    C = moe.capacity(xt.shape[0], cfg)
    buf = torch.randn(cfg.moe.num_experts, C, cfg.d_model, device="cuda",
                      dtype=x.dtype)
    parts = {
        "layer": lambda: p(x),
        "route": lambda: moe.route(p, xt, cfg),
        "experts": lambda: torch.bmm(F.silu(torch.bmm(buf, p["wi"]))
                                     * torch.bmm(buf, p["wg"]), p["wo"])}
    if "shared" in p:
        parts["shared"] = lambda: apply_mlp(p["shared"], xt, cfg.act)
    t = {"tokens": xt.shape[0], "capacity": C}
    with torch.inference_mode():
        t["layer_events_ms"] = events_ms(torch, parts["layer"], iters=10,
                                         warmup=2)
        for name, fn in parts.items():
            t[name + "_device_ms"] = sum(
                profiled_kernels(torch, fn, iters=10).values()) or None
    dev = [t[n + "_device_ms"] for n in parts]
    if all(dev):
        rest = t["layer_device_ms"] - sum(dev[2:])
        t["write_gather_combine_device_ms"] = rest - t["route_device_ms"]
        t["dispatch_share"] = rest / t["layer_device_ms"]
    return t


# profiler kernel-name substrings of the MoE dispatch: the top-k sort, the
# argsort by expert and index_put's own sort; the accumulating buffer
# write; the gathers (x[flat_t], out_buf[e, slot]; also the embedding
# lookup)
MOE_MATCH = {"moe_sort": ("Sort", "sort"),
             "moe_index_put": ("indexing_backward", "index_put"),
             "moe_gather": ("index_elementwise", "gather")}


def zoo_one(torch, arch, cut, B, S, steps, seed):
    """Serve one config at full width in bf16 (weights drawn on the card):
    a warm-up, then a timed prefill_step with cache_capacity = S + steps
    and ``steps`` timed serve_step calls.  Returns the config's record;
    an MoE config's adds the share of (token, choice) pairs dropped in
    the timed prefill and decode, the expert loads, and one MoE layer's
    time split (``moe_breakdown``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch import specs
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import INPUT_SHAPES

    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if cut:
        cfg = dataclasses.replace(cfg, **cut)
    decodes = specs.applicable(cfg, INPUT_SHAPES["decode_32k"])[0]
    steps = steps if decodes else 0
    attn = attn_layers(cfg)
    t0 = time.perf_counter()
    model = model_lib.init_model(cfg, seed=seed, device="cuda")
    batch = zoo_inputs(torch, cfg, B, S, seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cap = S + steps
    # warm-up: one prefill and one decode step
    last, st = prefill_step(model, batch, cache_capacity=cap)
    if decodes:
        serve_step(model, st, last.argmax(-1).to(torch.int32)[:, None], S)
    del last, st
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with moe_inputs(model) as seen_prefill:
        launches.reset_launch_counts()
        t0 = time.perf_counter()
        last, state = prefill_step(model, batch, cache_capacity=cap)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    n_prefill = launches.launch_counts()["flash_attention"]
    tok = last.argmax(-1).to(torch.int32)[:, None]
    generated = [tok]
    with moe_inputs(model) as seen_decode:
        t0 = time.perf_counter()
        for t in range(steps):
            tok, state = serve_step(model, state, tok, S + t)
            generated.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    n_decode = launches.launch_counts()["flash_attention"] - n_prefill
    peak = torch.cuda.max_memory_allocated()
    generated = torch.cat(generated, 1)

    check(bool(torch.isfinite(last).all()), f"{arch}: non-finite logits")
    check(n_prefill == len(attn) and n_decode == 0,
          f"{arch}: flash_attention launched {n_prefill} times in the "
          f"prefill (want one per attention layer, {len(attn)}) and "
          f"{n_decode} in decode")
    windows = [attn_lib.layer_window(cfg, i) for i in attn]
    slots = [state[i]["k"].shape[1] for i in attn]
    check(slots == [min(w, cap) if w else cap for w in windows],
          f"{arch}: cache slots {sorted(set(slots))}")
    check(all(state[i]["k"].dtype == cfg.torch_dtype for i in attn),
          f"{arch}: cache not in {cfg.dtype}")
    mamba = [x for x in state if "h" in x and "conv" in x]
    check(all(x["h"].dtype == torch.float32
              and x["conv"].dtype == cfg.torch_dtype
              and bool(torch.isfinite(x["h"]).all()) for x in mamba),
          f"{arch}: Mamba states not finite f32 h and {cfg.dtype} conv")
    check(generated.shape == (B, steps + 1) and bool(
        ((generated >= 0) & (generated < cfg.vocab_size)).all()),
        f"{arch}: bad generated tokens")
    name = "embeds" if "embeds" in batch else "tokens"
    match = {"flash_attention": SOURCES["flash_attention"][2]}
    if cfg.moe is not None:
        match.update(MOE_MATCH)
    prof_prefill = device_profile(
        torch, lambda: prefill_step(model, batch, cache_capacity=cap),
        prefill_s * 1e3, match=match)
    prof_decode = (device_profile(
        torch, lambda: serve_step(model, state, tok, S + steps),
        decode_s * 1e3 / steps) if steps else None)
    out = {"arch": arch, "layers": cfg.num_layers,
           "layers_in_config": full_layers, "cut": cut or None,
           "params": model_lib.count_params(model), "dtype": cfg.dtype,
           "prefill_input": name, "batch": B, "prompt_len": S,
           "decode_steps": steps, "cache_capacity": cap,
           "ring_slots": sorted({n for n, w in zip(slots, windows) if w}),
           "setup_s": setup_s, "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": B * S / prefill_s,
           "decode_ms_per_step": decode_s * 1e3 / steps if steps else None,
           "decode_tokens_per_s": B * steps / decode_s if steps else None,
           "peak_memory_bytes": peak,
           "attention_layers": len(attn), "mamba_layers": len(mamba),
           "flash_attention_launches_per_prefill": n_prefill,
           "flash_attention_launches_decode": n_decode,
           "profiled_prefill": prof_prefill,
           "profiled_decode_step": prof_decode,
           "first_tokens": generated[:, :8].cpu().tolist()}
    if cfg.moe is not None:
        out["moe"] = {
            "layers": sum(b.use_moe for b in model.layers),
            "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
            "capacity_factor": cfg.moe.capacity_factor,
            "prefill": moe_stats(torch, model, seen_prefill),
            "first_moe_input_mean_cosine": mean_cosine(
                torch, seen_prefill[0][1]),
            "decode": moe_stats(torch, model, seen_decode),
            "breakdown": moe_breakdown(torch, model, *seen_prefill[0])}
    del model, state, batch, last, seen_prefill, seen_decode
    torch.cuda.empty_cache()
    return out


def zoo_serve_phase(torch) -> dict:
    """Each dense config of the zoo at full width, one at a time (each
    freed before the next): prefill, then greedy decode (hubert, an
    encoder, prefill only)."""
    runs = [zoo_one(torch, arch, cut, B, S, steps, seed=i)
            for i, (arch, cut, B, S, steps) in enumerate(ZOO_SERVE)]
    launches = {r["arch"]: r["flash_attention_launches_per_prefill"]
                for r in runs}
    emit("zoo_serve", runs=runs)
    return {"launches": sum(launches.values()), "by_arch": launches}


def expert_set_diffs(torch, cfg, routes_g, routes_c) -> list:
    """For each MoE call of a prefill, card vs CPU: the tokens whose
    expert sets differ, and how many of them sit at a near tie (the CPU's
    router probabilities at the K-th and (K+1)-th choice within
    ROUTE_GAP)."""
    K = cfg.moe.top_k
    out = []
    for (i, rg), (_, rc) in zip(routes_g, routes_c):
        sg = rg.gate_idx.cpu().sort(-1).values
        sc = rc.gate_idx.sort(-1).values
        rows = (sg != sc).any(-1).nonzero().flatten()
        near = 0
        if rows.numel():      # K < E: with K = E every set is all experts
            top = rc.probs[rows].sort(-1, descending=True).values
            near = int((top[:, K - 1] - top[:, K] < ROUTE_GAP).sum())
        out.append({"layer": i, "tokens": int(sg.shape[0]),
                    "differ": int(rows.numel()), "near_tie": near})
    return out


def zoo_crosscheck_phase(torch) -> dict:
    """f32 at full width, reduced depth.  Card (kernel) vs CPU (plain
    versions) on the same weights (drawn on the card, deep-copied to the
    CPU) for tinyllama (4 layers), gemma3 (one 6-layer unit, a prompt
    past its 1024 window), qwen2-moe (2 layers) and jamba (2 layers);
    an MoE config's expert sets in the prefill are compared token by
    token.  Then on the card, for every decoder, decode one token from
    a prefill's cache against a prefill one token longer (the
    reference's tolerance); an MoE layer's capacity depends on the
    call's token count, so with MoE the comparison is held only up to
    the first MoE layer where any of the three calls dropped a pair, and
    reported past it (jamba also runs with a capacity factor of E / K,
    C = T, where no call drops)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    card_cpu = []
    for arch, layers, S, steps in ZOO_CROSS:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        n_attn = len(attn_layers(cfg))
        t0 = time.perf_counter()
        gpu = model_lib.init_model(cfg, seed=11, device="cuda")
        cpu = copy.deepcopy(gpu).cpu()
        prompt = zoo_tokens(torch, cfg, 1, S, seed=12)
        res = {"setup_s": time.perf_counter() - t0}
        for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, None)):
            t1 = time.perf_counter()
            with moe_inputs(model) as seen:
                res[name] = greedy(torch, model, prompt.to(dev or "cuda"),
                                   steps - 1, dev, kernel="flash_attention")
            n_moe = sum(b.use_moe for b in model.layers)
            res[name + "_routes"] = moe_routes(torch, model, seen[:n_moe])
            res[name + "_s"] = time.perf_counter() - t1
        last_c, toks_c, dec_c, _, pre_c, _ = res["cpu"]
        last_g, toks_g, _, _, pre_g, dcd_g = res["cuda"]
        check(pre_c == 0 and (pre_g, dcd_g) == (n_attn, 0),
              f"{arch}: flash_attention launches cpu {pre_c}, card {pre_g} "
              f"+ {dcd_g}")
        e = float((last_g.cpu() - last_c).abs().max()) / float(
            last_c.abs().max())
        check(e <= XLSTM_REL_TOL, f"{arch}: prefill logits rel err {e}")
        first_diff, excused = first_token_diff(torch, toks_g, toks_c,
                                               [last_c] + dec_c)
        check(first_diff is None or excused,
              f"{arch}: card and CPU tokens differ at step {first_diff}")
        row = {"arch": arch, "layers": layers, "prompt_len": S,
               "tokens": steps, "launches_prefill": pre_g,
               "logits_rel_err": e, "tokens_identical": first_diff is None,
               "first_token_diff": first_diff, "near_tie_excused": excused,
               "setup_s": res["setup_s"], "cpu_s": res["cpu_s"],
               "card_s": res["cuda_s"]}
        if cfg.moe is not None:
            diffs = expert_set_diffs(torch, cfg, res["cuda_routes"],
                                     res["cpu_routes"])
            # past the first call with a difference the inputs differ
            for d in diffs:
                check(d["differ"] == d["near_tie"],
                      f"{arch}: layer {d['layer']}: {d['differ']} tokens "
                      f"chose other experts on the card, {d['near_tie']} "
                      f"at a near tie")
                if d["differ"]:
                    break
            row["expert_set_diffs"] = diffs
            row["dropped_prefill"] = [int((~r.keep).sum())
                                      for _, r in res["cpu_routes"]]
        card_cpu.append(row)
        del gpu, cpu, res
        torch.cuda.empty_cache()
    dvp = []
    for arch, layers, B, S, cf in ZOO_DVP:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        if cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        model = model_lib.init_model(cfg, seed=13, device="cuda")
        prompt = zoo_tokens(torch, cfg, B, S, seed=14)
        with moe_inputs(model) as seen:
            r = decode_vs_prefill(torch, model, prompt)
        # the first layer at or past which a call dropped a pair
        drop_layers = sorted({i for i, rt in moe_routes(torch, model, seen)
                              if not bool(rt.keep.all())})
        held = drop_layers[0] if drop_layers else layers
        check(all(r["layers_close"][:held]) and (held < layers
                                                 or r["close"]),
              f"{arch}: decode vs prefill max abs err {r['max_abs_err']}, "
              f"layers {r['layer_err'][:held]}")
        dvp.append({"arch": arch, "layers": layers, "batch": B,
                    "prompt_len": S, "capacity_factor": (
                        cfg.moe.capacity_factor if cfg.moe else None),
                    "max_abs_err": r["max_abs_err"],
                    "logit_max_abs": r["logit_max_abs"],
                    "layer_err": r["layer_err"],
                    "moe_layers_that_dropped": drop_layers,
                    "layers_held": held, "logits_held": held == layers})
        del model, seen
        torch.cuda.empty_cache()
    out = {"dtype": "f32", "card_vs_cpu": card_cpu,
           "decode_vs_prefill": dvp,
           "tolerances": {"rel_to_max": XLSTM_REL_TOL,
                          "token_gap": TOKEN_GAP, "route_gap": ROUTE_GAP,
                          "decode_atol": DECODE_ATOL,
                          "decode_rtol": DECODE_RTOL}}
    emit("zoo_crosscheck", **out)
    return out


# ------------------------------------------------------ phases 4b-4d (train)

def attn_grad_inputs(torch, B, S, T, H, KV, hd, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g)
    return r(B, S, H, hd), r(B, T, KV, hd), r(B, T, KV, hd), r(B, S, H, hd)


def attention_grad_phase(torch) -> float:
    """The backward kernel's dQ, dK, dV against torch autograd of the
    plain version, at the training shapes, small causal, window, softcap
    and GQA cases, and both sides of the switch between its one-launch
    and two-launch paths; then at the zoo's training shapes in f32 and
    bf16 (held against the plain version's f32 gradient of the same
    values: bf16 within one bf16 ulp of it rounded, plus the f32
    tolerance); a rerun must give bit-identical gradients.  Returns the
    largest max abs error of the f32 cases."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cases, worst = [], 0.0
    zoo = [(B, S, S, H, KV, hd, causal, window, 0.0, dt, label)
           for B, S, H, KV, hd, causal, window, label in ZOO_ATTN_GRAD
           for dt in ("float32", "bfloat16")]
    for B, S, T, H, KV, hd, causal, window, softcap, dt, label in (
            [(*c, "float32", None) for c in ATTN_GRAD_CASES] + zoo):
        q, k, v, do = (x.to(getattr(torch, dt)) for x in attn_grad_inputs(
            torch, B, S, T, H, KV, hd, S + hd))
        masks = dict(causal=causal, window=window, softcap=softcap)
        _, lse = fa_ops._forward(q, k, v, causal, window, softcap, True)
        got = fa_ops.flash_attention_bwd(q, k, v, lse, do, **masks)
        again = fa_ops.flash_attention_bwd(q, k, v, lse, do, **masks)
        want = fa_ops.attention_grad_plain(q.float(), k.float(), v.float(),
                                           do.float(), **masks)
        torch.cuda.synchronize()
        case = {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd, **masks,
                "dtype": dt, "config": label,
                "kernel_launches": fa_ops.backward_launches(T, hd)}
        for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
            err = (a.float() - w).abs()
            e, scale = float(err.max()), float(w.abs().max())
            if dt == "float32":
                ok = e <= ATTN_GRAD_REL_TOL * scale
                worst = max(worst, e)
            else:
                ok = bool((err <= bf16_ulp(torch, w.bfloat16().float().abs())
                           + ATTN_GRAD_REL_TOL * scale).all())
            check(a.dtype == q.dtype and bool(torch.isfinite(a).all())
                  and ok,
                  f"attention backward {case} {name}: max abs err {e}, "
                  f"largest {scale}")
            check(torch.equal(a, b), f"attention backward {case} {name}: "
                                     f"a rerun differs")
            case[name] = [e, scale]
        cases.append(case)
        del q, k, v, do, lse, got, again, want
        torch.cuda.empty_cache()
    emit("attention_grad", tolerance_rel_to_max=ATTN_GRAD_REL_TOL,
         bf16_tolerance="one bf16 ulp of the plain f32 gradient rounded, "
                        "plus the f32 tolerance",
         bit_identical_rerun=True, max_abs_err=worst, cases=cases)
    return worst


def mlstm_grad_phase(torch) -> float:
    """The mLSTM backward kernel (``mlstm_chunkwise_bwd``, from the
    forward kernel's chunk-start states) against torch autograd of the
    chunkwise plain version on the card, per gradient within
    MLSTM_GRAD_REL_TOL of its largest magnitude; a rerun must be
    bit-identical.  Returns the largest max abs error."""
    from repro_torch.kernels.mlstm_scan import ops as ml_ops
    cases, worst = [], 0.0
    for B, S, H, dh, carried in MLSTM_GRAD_CASES:
        q, k, v, i, f, st = mlstm_inputs(torch, B, S, H, dh, carried,
                                         seed=dh)
        g = torch.Generator(device="cuda").manual_seed(dh + 1)
        dh_ = torch.randn(B, S, H, dh, device="cuda", generator=g)
        h, _, states = ml_ops._launch(q, k, v, i, f, st, True)
        got = ml_ops.mlstm_chunkwise_bwd(q, k, v, i, f, st, h, dh_, states)
        again = ml_ops.mlstm_chunkwise_bwd(q, k, v, i, f, st, h, dh_, states)
        want = ml_ops.mlstm_chunkwise_grad_plain(q, k, v, i, f, st, dh_)
        torch.cuda.synchronize()
        case = {"B": B, "S": S, "H": H, "dh": dh, "carried_state": carried}
        for name, a, b, w in zip(("dq", "dk", "dv", "di", "df"), got, again,
                                 want):
            e, scale = float((a - w).abs().max()), float(w.abs().max())
            check(bool(torch.isfinite(a).all())
                  and e <= MLSTM_GRAD_REL_TOL * scale,
                  f"mLSTM backward {case} {name}: max abs err {e}, largest "
                  f"{scale}")
            check(torch.equal(a, b), f"mLSTM backward {case} {name}: a "
                                     f"rerun differs")
            case[name] = [e, scale]
            worst = max(worst, e)
        cases.append(case)
        del q, k, v, i, f, st, h, states, got, again, want
        torch.cuda.empty_cache()
    emit("mlstm_grad", tolerance_rel_to_max=MLSTM_GRAD_REL_TOL,
         bit_identical_rerun=True, max_abs_err=worst, cases=cases)
    return worst


@contextlib.contextmanager
def plain_calls():
    """Count the calls of the plain versions (attention, its gradient,
    the chunkwise mLSTM and its gradient) while active: a dict name ->
    calls.  The wrappers reach them through their modules, so the
    counters see every call."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm_scan import ops as ml_ops
    names = [(fa_ops, "attention_plain"), (fa_ops, "attention_grad_plain"),
             (ml_ops, "mlstm_chunkwise_plain"),
             (ml_ops, "mlstm_chunkwise_grad_plain")]
    calls = {n: 0 for _, n in names}
    saved = [(mod, n, getattr(mod, n)) for mod, n in names]

    def counted(n, fn):
        def call(*args, **kwargs):
            calls[n] += 1
            return fn(*args, **kwargs)
        return call

    for mod, n, fn in saved:
        setattr(mod, n, counted(n, fn))
    try:
        yield calls
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def zoo_train_one(torch, arch, cut, B, S, seed) -> dict:
    """TRAIN_STEPS bf16 ``train_step`` calls (remat on) of one config at
    full width on one fixed batch of tokens, the last under the profiler
    (its busy share is taken against steps 2 to TRAIN_STEPS - 1).
    The loss must fall; each step must launch the attention backward
    (and for xlstm the mLSTM backward) once per such layer, and the
    forward kernels twice in the full units (remat runs their forward
    again) and once in the remainder layers (gemma3's last 4)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.launch.steps import PerfKnobs, train_step
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw_init

    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if cut:
        cfg = dataclasses.replace(cfg, **cut)
    pat = cfg.layer_pattern
    kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
    n_attn, n_mlstm = kinds.count("attn"), kinds.count("mlstm")
    units = cfg.num_layers // len(pat) * len(pat)     # the remat'd layers
    fwd = {k: kinds.count(k) + kinds[:units].count(k)
           for k in ("attn", "mlstm")}
    t0 = time.perf_counter()
    model = model_lib.init_model(cfg, seed=seed, device="cuda")
    opt = adamw_init(model)
    batch = {"tokens": zoo_tokens(torch, cfg, B, S, seed)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    knobs = PerfKnobs(remat=True)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, per_step = [], [], []
    match = {"attention_bwd": "flash_attention_bwd",
             "attention_fwd": "flash_attention_kernel",
             "mlstm_bwd": SOURCES["mlstm_scan_bwd"][2], "mlstm_fwd": "mlstm_scan"}
    prof = None
    for n in range(TRAIN_STEPS):
        def step():
            losses.append(float(train_step(model, opt, batch, knobs=knobs,
                                           lr=ZOO_TRAIN_LR)))
        launches.reset_launch_counts()
        if n + 1 < TRAIN_STEPS:
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
        else:   # the last step under the profiler, against steps 2 on
            prof = device_profile(torch, step,
                                  sum(step_s[1:]) / len(step_s[1:]) * 1e3,
                                  top=10, match=match, host=False)
        per_step.append(launches.launch_counts())
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": fwd["attn"], "flash_attention_bwd": n_attn,
            "mlstm_scan": fwd["mlstm"], "mlstm_scan_bwd": n_mlstm}
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{arch}: the loss did not fall over {TRAIN_STEPS} steps: "
          f"{losses}")
    for counts in per_step:
        check(all(counts[n] == w for n, w in want.items())
              and counts["flash_attention_bwd"] + counts[
                  "mlstm_scan_bwd"] > 0,
              f"{arch}: launches a step {counts}, want {want}")
    ms = sum(step_s[1:]) / len(step_s[1:]) * 1e3  # step 1 warms up
    out = {"arch": arch, "layers": cfg.num_layers,
           "layers_in_config": full_layers, "cut": cut or None,
           "params": model_lib.count_params(model), "dtype": cfg.dtype,
           "batch": B, "seq": S, "remat": True, "lr": ZOO_TRAIN_LR,
           "setup_s": setup_s, "losses": losses,
           "ms_per_step": ms, "first_step_ms": step_s[0] * 1e3,
           "tokens_per_s": B * S / (ms / 1e3), "peak_memory_bytes": peak,
           "launches_per_step": per_step[-1],
           "attention_layers": n_attn, "mlstm_layers": n_mlstm,
           "profiled_step": prof}
    del model, opt, batch
    torch.cuda.empty_cache()
    return out


def zoo_train_phase(torch) -> dict:
    """Each training config of ZOO_TRAIN at full width in bf16, one at a
    time; no plain version may run (the plain calls are counted).
    Returns the launches of each kernel over the phase."""
    runs, total = [], {}
    with plain_calls() as plain:
        for i, (arch, cut, B, S) in enumerate(ZOO_TRAIN):
            r = zoo_train_one(torch, arch, cut, B, S, seed=20 + i)
            runs.append(r)
            for n, c in r["launches_per_step"].items():
                total[n] = total.get(n, 0) + c * TRAIN_STEPS
    check(not any(plain.values()), f"zoo_train: plain versions ran on the "
                                   f"card: {plain}")
    emit("zoo_train", steps=TRAIN_STEPS, plain_calls=plain, runs=runs,
         launches=total,
         method="ms_per_step: host clock around each train_step ending in "
                "a sync, mean of steps 2-4; peak_memory_bytes: "
                "torch.cuda.max_memory_allocated over the 5 steps; "
                "profiled_step: step 5 under the profiler, the card's "
                "activity alone (busy_share = its device time over "
                "ms_per_step)")
    return total


def train_cross_grads(torch, model, tokens, jitter=False):
    """(loss, {leaf: gradient}, the MoE layers' routes) of one training
    step's ``lm_loss`` with remat; with ``jitter`` the first block's
    input moves by one ulp (``ulp_jitter``), its gradient passing
    through to the embedding unchanged."""
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import grads_of

    def moved(block, args):
        x = args[0]
        # x + (j - x) is j exactly (the difference of neighbours is exact)
        return (x + (ulp_jitter(torch, x.detach()) - x.detach()),) + args[1:]

    model.zero_grad(set_to_none=True)
    hook = (model.layers[0].register_forward_pre_hook(moved)
            if jitter else None)
    try:
        with moe_inputs(model) as seen:
            loss, _ = model_lib.lm_loss(model, {"tokens": tokens},
                                        remat=True)
            loss.backward()
    finally:
        if hook is not None:
            hook.remove()
    n_moe = sum(b.use_moe for b in model.layers)
    grads = {n: g.detach().cpu().clone()
             for n, g in grads_of(model).items()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, moe_routes(torch, model,
                                                  seen[:n_moe])


def zoo_train_crosscheck_phase(torch) -> dict:
    """f32 at full width, reduced depth: the loss and the gradients of
    one training step (``lm_loss`` with remat, then backward) on the
    card (the kernels) and on a CPU copy of the same weights (the plain
    versions).  Losses to TRAIN_CROSS_LOSS_RTOL, every leaf's gradient
    within TRAIN_CROSS_GRAD_REL of its largest magnitude; a leaf past it
    is held to TRAIN_ROUNDING_FACTOR times its one-ulp sensitivity on
    the CPU where that sensitivity is at least TRAIN_CROSS_GRAD_REL / 10
    (the leaves and their sensitivities are reported).  For MoE the
    expert sets are compared token by token first: a token that chose
    other experts on the card is excused only at a near tie, and then
    the step is drawn again from the next token seed (at most
    TRAIN_CROSS_DRAWS draws), so that every gradient is held on a draw
    where all routes agree."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    rows = []
    for arch, layers, B, S in ZOO_TRAIN_CROSS:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        t0 = time.perf_counter()
        gpu = model_lib.init_model(cfg, seed=31, device="cuda")
        cpu = copy.deepcopy(gpu).cpu()
        tied_draws = []
        for draw in range(TRAIN_CROSS_DRAWS):
            tokens = zoo_tokens(torch, cfg, B, S, seed=32 + draw)
            t1 = time.perf_counter()
            loss_g, grads_g, routes_g = train_cross_grads(torch, gpu, tokens)
            t2 = time.perf_counter()
            loss_c, grads_c, routes_c = train_cross_grads(torch, cpu,
                                                          tokens.cpu())
            t3 = time.perf_counter()
            rel = abs(loss_g - loss_c) / abs(loss_c)
            check(rel <= TRAIN_CROSS_LOSS_RTOL,
                  f"{arch}: training loss card {loss_g} vs CPU {loss_c}")
            if cfg.moe is None:
                break
            diffs = expert_set_diffs(torch, cfg, routes_g, routes_c)
            for d in diffs:
                check(d["differ"] == d["near_tie"],
                      f"{arch}: layer {d['layer']}: {d['differ']} tokens "
                      f"chose other experts on the card, {d['near_tie']} "
                      f"at a near tie")
            if not any(d["differ"] for d in diffs):
                break
            tied_draws.append({"token_seed": 32 + draw, "loss_rel_err": rel,
                               "expert_set_diffs": diffs})
        check(len(tied_draws) < TRAIN_CROSS_DRAWS,
              f"{arch}: routes differed at a near tie in every one of "
              f"{TRAIN_CROSS_DRAWS} draws; no gradient held: {tied_draws}")
        scale = {n: max(float(g.abs().max()), 1e-30)
                 for n, g in grads_c.items()}
        g_err = {n: float((grads_g[n] - g).abs().max()) / scale[n]
                 for n, g in grads_c.items()}
        worst = max(g_err, key=g_err.get)
        row = {"arch": arch, "layers": layers, "batch": B, "seq": S,
               "token_seed": 32 + len(tied_draws),
               "loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_err": rel,
               "worst_grad_rel_err": g_err[worst], "worst_grad_leaf": worst,
               "card_s": t2 - t1, "cpu_s": t3 - t2}
        if cfg.moe is not None:
            row["expert_set_diffs"] = diffs
            row["tied_draws"] = tied_draws
        past = [n for n, e in g_err.items() if e > TRAIN_CROSS_GRAD_REL]
        if past:
            _, grads_j, _ = train_cross_grads(torch, cpu, tokens.cpu(),
                                              jitter=True)
            sens = {n: float((grads_j[n] - grads_c[n]).abs().max())
                    / scale[n] for n in past}
            row["one_ulp_sensitivity"] = sens
            row["past_gate"] = {n: g_err[n] for n in past}
            for n in past:
                check(sens[n] >= TRAIN_CROSS_GRAD_REL / 10
                      and g_err[n] <= TRAIN_ROUNDING_FACTOR * sens[n],
                      f"{arch}: first-step gradient of {n} rel err "
                      f"{g_err[n]}, its one-ulp sensitivity {sens[n]}")
        row["setup_s"] = t1 - t0
        rows.append(row)
        del gpu, cpu, grads_g, grads_c
        torch.cuda.empty_cache()
    out = {"dtype": "f32", "runs": rows,
           "tolerances": {"loss_rtol": TRAIN_CROSS_LOSS_RTOL,
                          "grad_rel_to_max": TRAIN_CROSS_GRAD_REL,
                          "past_it_times_one_ulp_sensitivity":
                              TRAIN_ROUNDING_FACTOR,
                          "route_gap": ROUTE_GAP,
                          "draws": TRAIN_CROSS_DRAWS}}
    emit("zoo_train_crosscheck", **out)
    return out


def train_cli_phase(torch) -> dict:
    """``python -m repro_torch.launch.train --arch <id>``'s
    ``train_arch`` for every config's reduced variant on the card,
    TRAIN_STEPS steps at the CLI's batch and sequence: finite losses."""
    from repro_torch.configs import list_archs
    from repro_torch.launch.train import train_arch
    runs = []
    for arch in list_archs():
        t0 = time.perf_counter()
        losses = train_arch(arch, TRAIN_STEPS, CLI_TRAIN_BATCH,
                            CLI_TRAIN_SEQ, device="cuda", verbose=False)
        check(all(np.isfinite(losses)), f"train_cli {arch}: {losses}")
        runs.append({"arch": arch, "losses": losses,
                     "seconds": time.perf_counter() - t0})
    emit("train_cli", steps=TRAIN_STEPS, batch=CLI_TRAIN_BATCH,
         seq=CLI_TRAIN_SEQ, runs=runs)
    return {"runs": runs}


def timed_expert_steps(torch, spec, corpus, steps=20, warmup=3) -> dict:
    """ms per training step of one expert at the experiment's batch
    (16 x 128), on fresh weights: host clock around ``steps`` steps
    ending in a sync, after a warm-up."""
    from repro_torch.core.training import expert_step, to_device
    from repro_torch.data.batching import BatchIterator
    from repro_torch.models.model import init_model
    from repro_torch.optim import adamw_init
    model = init_model(spec.cfg, seed=0, device="cuda")
    opt = adamw_init(model)
    it = BatchIterator(corpus, spec.train_mixture, TRAIN_BATCH, SEQ, seed=1)
    batches = [to_device(next(it), "cuda") for _ in range(steps + warmup)]
    for b in batches[:warmup]:
        opt, _ = expert_step(model, opt, b, lr=1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[warmup:]:
        opt, _ = expert_step(model, opt, b, lr=1e-3)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"ms_per_step": ms,
            "tokens_per_s": TRAIN_BATCH * SEQ / (ms / 1e3),
            "step": lambda: expert_step(model, opt, batches[-1], lr=1e-3)}


def leaf_errors(a, b) -> dict:
    """Per parameter of modules ``a`` (card) and ``b`` (CPU): max abs
    difference over the CPU's largest magnitude."""
    out = {}
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        y = y.detach()
        out[n] = float((x.detach().cpu() - y).abs().max()) / max(
            float(y.abs().max()), 1e-12)
    return out


def adam_agreement(a, b) -> dict:
    """Weights of ``a`` (card) and ``b`` (CPU) after Adam steps, per
    leaf: the largest distance, and how many elements lie farther apart
    than TRAIN_REL_TOL of the leaf's largest magnitude."""
    out = {}
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        d = (x.detach().cpu() - y.detach()).abs()
        far = d > TRAIN_REL_TOL * float(y.detach().abs().max())
        out[n] = {"max_abs": float(d.max()), "n_far": int(far.sum()),
                  "size": d.numel()}
    return out


def card_vs_cpu_training(torch, corpus, rc) -> dict:
    """3 expert steps (the largest expert) and 3 router steps from the
    same starting weights on the card and on a CPU copy.  Gates: the 3
    losses to rtol TRAIN_REL_TOL; the first step's gradients, taken from
    the same weights, within TRAIN_REL_TOL of each leaf's largest
    gradient; after the 3 steps every weight within 2 * 3 * lr of the
    CPU's.  Weights are not held to TRAIN_REL_TOL of their leaf: Adam
    divides each gradient by its own magnitude, so an element whose
    gradient is within rounding of zero steps by about lr either way,
    and one whose gradient is small carries that gradient's relative
    error into a full-size step.  How many elements lie farther apart
    than that is reported (``far_weights``)."""
    from repro_torch.core.library import paper_library_specs
    from repro_torch.core.router import init_router
    from repro_torch.core.training import expert_step, router_step, to_device
    from repro_torch.data.batching import BatchIterator
    from repro_torch.models.model import init_model
    from repro_torch.optim import adamw_init
    spec = paper_library_specs(vocab=512)[0]
    gpu_e = init_model(spec.cfg, seed=5, device="cuda")
    gpu_r = init_router(rc, seed=6, device="cuda")
    out = {}
    for name, gpu, lr in (("expert", gpu_e, 1e-3), ("router", gpu_r, 5e-5)):
        cpu = copy.deepcopy(gpu).cpu()
        it = BatchIterator(corpus, spec.train_mixture, TRAIN_BATCH, SEQ, seed=9)
        batches = [next(it) for _ in range(3)]
        targets = np.random.default_rng(3).uniform(
            1, 6, (3, TRAIN_BATCH, rc.n_models)).astype(np.float32)
        losses, grads = {}, {}
        for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
            opt, ls = adamw_init(model), []
            for i, b in enumerate(batches):
                tb = to_device(b, dev)
                if name == "expert":
                    opt, loss = expert_step(model, opt, tb, lr=lr)
                else:
                    opt, loss = router_step(
                        model, opt, rc, tb["tokens"],
                        torch.from_numpy(targets[i]).to(dev), lr=lr)
                ls.append(float(loss))
                if i == 0:
                    grads[dev] = {n: p.grad.detach().cpu().clone()
                                  for n, p in model.named_parameters()}
            losses[dev] = ls
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                       losses["cpu"]))
        g_err = {n: float((grads["cuda"][n] - g).abs().max())
                 / max(float(g.abs().max()), 1e-30)
                 for n, g in grads["cpu"].items()}
        agree = adam_agreement(gpu, cpu)
        worst_g = max(g_err, key=g_err.get)
        worst_w = max(agree, key=lambda n: agree[n]["max_abs"])
        bound = 2 * len(batches) * lr
        check(rel <= TRAIN_REL_TOL and g_err[worst_g] <= TRAIN_REL_TOL
              and agree[worst_w]["max_abs"] <= bound,
              f"{name} steps card vs CPU: losses {losses}, first-step "
              f"gradient of {worst_g} {g_err[worst_g]}, weights of "
              f"{worst_w} {agree[worst_w]} (bound {bound})")
        n_far = sum(a["n_far"] for a in agree.values())
        out[name] = {"losses": losses, "loss_rel_err": rel,
                     "worst_grad_rel_err": g_err[worst_g],
                     "worst_grad_leaf": worst_g,
                     "weights_max_abs": agree[worst_w]["max_abs"],
                     "weights_bound": bound,
                     "far_weights": n_far,
                     "far_share": n_far / sum(a["size"]
                                              for a in agree.values()),
                     "far_by_leaf": {n: a["n_far"] for n, a in agree.items()
                                     if a["n_far"]}}
    return out


def train_path_phase(torch) -> dict:
    """``run_experiment`` on the card at the paper library's widths
    (the default ``ExperimentConfig``, nothing cut); returns the phase's
    line."""
    from repro_torch.core import experiment as ex
    from repro_torch.core.library import paper_library_specs
    from repro_torch.core.router import RouterConfig
    from repro_torch.data.corpus import DomainCorpus
    from repro_torch.kernels import launches
    from repro_torch.kernels.flash_attention import ops as fa_ops

    xc = ex.ExperimentConfig()
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    res = ex.run_experiment(xc, verbose=False, save=True, device="cuda",
                            timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts["flash_attention"] > 0 and counts["flash_attention_bwd"] > 0,
          f"attention kernels not launched in training: {counts}")

    # per-expert step time and a profiled step of the largest expert
    corpus = DomainCorpus(vocab_size=xc.vocab, seed=xc.seed)
    specs = paper_library_specs(vocab=xc.vocab)
    per_expert = {}
    for spec in specs:
        t = timed_expert_steps(torch, spec, corpus)
        per_expert[spec.name] = {k: v for k, v in t.items() if k != "step"}
        if spec is specs[0]:
            largest = t
    fa_ops.flash_attention_bwd.launches = 0
    largest["step"]()
    torch.cuda.synchronize()
    bwd_per_step = fa_ops.flash_attention_bwd.launches
    profile = device_profile(torch, largest["step"],
                             largest["ms_per_step"],
                             match={"attention_fwd": SOURCES[
                                 "flash_attention"][2],
                                 "attention_bwd": SOURCES[
                                     "flash_attention_bwd"][2]})
    rc = RouterConfig(n_models=len(specs), vocab_size=xc.vocab)
    cross = card_vs_cpu_training(torch, corpus, rc)

    # gates: finite results, every expert learned, the router improved
    flat = [res["router_eps"], res["router_val_best"],
            *res["selection_accuracy"].values(),
            *res["aggregate_accuracy"].values(),
            *(r["accuracy"] for r in res["pareto"]["rows"])]
    check(all(np.isfinite(x) for x in flat), f"non-finite results: {flat}")
    tenths = {}
    for spec, log in zip(specs, timings["expert_logs"]):
        n = max(len(log.train_loss) // 10, 1)
        first, last = (float(np.mean(log.train_loss[:n])),
                       float(np.mean(log.train_loss[-n:])))
        check(np.isfinite(log.train_loss).all() and last < first,
              f"{spec.name}: loss {first} over its first tenth, {last} "
              f"over its last")
        tenths[spec.name] = [first, last]
    rlog = timings["router_log"]
    check(rlog.best_val < rlog.val_loss[0],
          f"router: best validation {rlog.best_val}, first "
          f"{rlog.val_loss[0]}")
    steps = xc.expert_steps * len(specs)
    out = {"config": res["config"], "wall_s": wall, "stage_s": {k: timings[k] for k in STAGES},
           "expert_steps": steps,
           "ms_per_expert_step": timings["experts"] * 1e3 / steps,
           "per_expert_step": per_expert,
           "launches": counts,
           "attention_bwd_per_expert_step": bwd_per_step,
           "profiled_expert_step": profile,
           "peak_memory_bytes": peak,
           "expert_loss_first_last_tenth": tenths,
           "router_val": {"first": rlog.val_loss[0], "best": rlog.best_val,
                          "best_step": rlog.best_step,
                          "checks": len(rlog.val_loss),
                          "stopped_early": rlog.stopped_early},
           "router_eps": res["router_eps"],
           "selection_accuracy": res["selection_accuracy"],
           "aggregate_accuracy": res["aggregate_accuracy"],
           "silhouette": res["silhouette"],
           "pareto": [{k: r[k] for k in ("lam", "accuracy", "size_frac")}
                      for r in res["pareto"]["rows"]],
           "card_vs_cpu": cross}
    emit("train_path", **out)
    return out


def adapt_path_phase(torch) -> dict:
    """The drift scenario of ``benchmarks/run.py``'s ``bench_drift`` on
    the port, through ``serve()``: the trained library and router from
    ``train_path`` (read back with ``load_artifacts``); the router's
    favourite expert regresses to fresh weights while traffic moves to
    two of its home domains; a frozen and an adapting engine
    (``adapt_every=8``, ``"head"``) get the same stream."""
    from repro_torch.core import experiment as ex
    from repro_torch.core.qtable import per_prompt_metrics
    from repro_torch.core.training import make_router_update_step
    from repro_torch.data.corpus import DOMAINS
    from repro_torch.models.model import init_model
    from repro_torch.serving import Request, TryageEngine

    art, cfg = ex.load_artifacts(), ex.load_results()["config"]
    lib, rp, rc = art["library"], art["router_params"], art["rc"]
    test_b = []
    for di, d in enumerate(DOMAINS):
        test_b += ex._eval_batches(art["corpus"], {d: 1.0},
                                   cfg["n_test_per_domain"], cfg["seq"],
                                   cfg["seed"] + 303 + di)
    cat = lambda k: np.concatenate([b[k] for b in test_b])
    tokens, targets, mask, domain = (cat("tokens"), cat("targets"),
                                     cat("mask"), cat("domain"))
    check(np.array_equal(tokens, art["test_tokens"]),
          "drift: rebuilt eval batches differ from the saved test tokens")
    q_pre, pred = art["q_test"]["loss"], art["pred"]
    names = [e.name for e in lib.experts]
    choice0 = pred.argmin(1)
    E = int(np.bincount(choice0, minlength=len(lib)).argmax())
    good_E = (choice0 == E) & (q_pre[:, E] <= q_pre.min(1) + DRIFT_TOL)
    counts = np.array([(good_E & (domain == di)).sum()
                       for di in range(len(DOMAINS))])
    D = sorted(np.argsort(counts)[::-1][:2].tolist())
    pool_pre = np.arange(len(tokens))
    pool_post = np.where(np.isin(domain, D))[0]
    orig = lib.experts[E].params
    bad = init_model(lib.experts[E].cfg, seed=4321, device="cuda")
    q_post = q_pre.copy()
    q_post[:, E] = np.concatenate([per_prompt_metrics(bad, b)[0]
                                   for b in test_b])
    W, n_pre, n_post = 32, 96, 288

    def tolacc(ch, idx, L):
        return float((L[idx, ch] <= L[idx].min(1) + DRIFT_TOL).mean())

    def timeline(adapt: bool):
        rng = np.random.default_rng(0)
        eng = TryageEngine(lib, rp, rc, [], max_batch=32,
                           adapt_every=8 if adapt else 0, adapt_lr=0.1,
                           adapt_trainable="head", adapt_batch=32,
                           replay_cap=128, device="cuda")
        uid = [0]
        stale = []

        def window(pool, L):
            idx = rng.choice(pool, size=W, replace=len(pool) < W)
            reqs = [Request(uid=uid[0] + j, tokens=tokens[i],
                            targets=targets[i], mask=mask[i])
                    for j, i in enumerate(idx)]
            uid[0] += W
            out = sorted(eng.serve(iter(reqs)), key=lambda r: r.uid)
            stale.append(sorted(eng.cache.stale_versions(eng.router_version)))
            ch = np.array([names.index(r.expert) for r in out])
            return tolacc(ch, idx, L), ch, idx

        try:
            lib.experts[E].params = orig
            pre = [window(pool_pre, q_pre) for _ in range(n_pre // W)]
            lib.experts[E].params = bad
            post = [window(pool_post, q_post) for _ in range(n_post // W)]
        finally:
            lib.experts[E].params = orig
        return pre, post, eng, stale

    t0 = time.perf_counter()
    pre_f, post_f, frozen, _ = timeline(adapt=False)
    frozen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre_a, post_a, adapting, stale = timeline(adapt=True)
    adapting_s = time.perf_counter() - t0
    st = adapting.stats
    before = float(np.mean([tolacc(ch, idx, q_pre) for _, ch, idx in post_f]))
    frozen_post = float(np.mean([a for a, _, _ in post_f]))
    adapted_post = float(np.mean([a for a, _, _ in post_a[-3:]]))
    drop = before - frozen_post
    recovered = (adapted_post - frozen_post) / drop if drop > 0 else None
    check(st.adapt_updates == st.router_version == adapting.router_version
          > 0, f"drift: {st.adapt_updates} updates, version "
               f"{st.router_version}")
    check(not any(stale), f"drift: stale cache versions after a swap {stale}")
    # the first window is routed in one admission batch, before any
    # feedback: the two engines must decide it identically
    check(np.array_equal(pre_f[0][1], pre_a[0][1]),
          "drift: frozen and adapting engines differ before the first "
          "update")
    check(frozen.stats.adapt_updates == 0, "drift: the frozen engine adapted")

    # one "head" and one "all" step on the card and on a CPU copy of the
    # trained router, from one replay batch
    toks, eidx, obs = adapting.replay.sample(32, np.random.default_rng(1))
    steps = {}
    for trainable, tol in (("head", ADAPT_HEAD_TOL), ("all", ADAPT_ALL_TOL)):
        step = make_router_update_step(rc, lr=0.1, trainable=trainable)
        new_g, loss_g = step(rp, torch.from_numpy(toks).cuda(), eidx, obs)
        rp_cpu = copy.deepcopy(rp).cpu()
        new_c, loss_c = step(rp_cpu, torch.from_numpy(toks), eidx, obs)
        errs = leaf_errors(new_g, new_c)
        worst = max(errs.values())
        check(worst <= tol, f"adapt step {trainable!r} card vs CPU: "
                            f"{max(errs, key=errs.get)} {worst}")
        steps[trainable] = {"loss": [float(loss_g), float(loss_c)],
                            "worst_leaf_rel_err": worst, "tolerance": tol}
    out = {"regressed_expert": names[E],
           "shift_domains": [DOMAINS[d] for d in D],
           "window": W, "pre_windows": n_pre // W,
           "post_windows": n_post // W,
           "frozen_acc": {"pre": [a for a, _, _ in pre_f],
                          "post": [a for a, _, _ in post_f]},
           "adapted_acc": {"pre": [a for a, _, _ in pre_a],
                           "post": [a for a, _, _ in post_a]},
           "before_acc": before, "frozen_post_acc": frozen_post,
           "adapted_post_acc": adapted_post, "recovered_frac": recovered,
           "updates": st.adapt_updates, "router_version": st.router_version,
           "feedback_events": st.feedback_events,
           "adapt_time_s": st.adapt_time_s,
           "adapt_ms_per_update": st.adapt_time_s * 1e3 / st.adapt_updates,
           "pre_err": st.adapt_pre_err, "post_err": st.adapt_post_err,
           "wall_s": {"frozen": frozen_s, "adapting": adapting_s},
           "card_vs_cpu_step": steps}
    emit("adapt_path", **out)
    return out


# ------------------------------------------------------------ phase 4f

class TierLog:
    """Which tier answered each request of an engine's run: wraps the
    cache's exact probe (``lookup``) and semantic probe
    (``lookup_semantic``, with the nearest neighbour's squared distance
    read from the T3 index before the probe) and maps the probes back
    to rows.  ``run()`` and ``pipeline.admit`` probe every row of an
    admission batch in order, then the exact misses in order."""

    def __init__(self, eng):
        self.events = []
        cache = eng.cache
        lookup = cache.lookup
        sem = getattr(cache, "lookup_semantic", None)

        def exact(key):
            entry, tier = lookup(key)
            self.events.append(("exact", tier, None))
            return entry, tier

        def semantic(emb, key, version):
            found = cache.semantic._ctx.get((key[3], key[4]))
            near = found[0].query(np.asarray(emb, np.float32).ravel()) \
                if found is not None else None
            entry, status = sem(emb, key, version)
            self.events.append(("sem", status,
                                None if near is None else near[1]))
            return entry, status

        cache.lookup = exact
        if sem is not None:
            cache.lookup_semantic = semantic

    def rows(self, n: int) -> tuple[list, list]:
        """(tier per row: "t1"/"t2"/"t3"/"fresh", the squared distance
        of each row's T3 probe or None) for the last ``n`` rows."""
        tiers, d2, misses, row = [], [], [], 0
        for kind, status, dist in self.events:
            if kind == "exact":
                tiers.append(status or "fresh")
                d2.append(None)
                if not status:
                    misses.append(row)
                row += 1
            else:
                i = misses.pop(0)
                d2[i] = dist
                if status == "hit":
                    tiers[i] = "t3"
        return tiers[-n:], d2[-n:]


def cache_tiers_phase(torch) -> dict:
    """``benchmarks/run.py``'s ``bench_cache`` at full size on the card:
    ``train_path``'s library (11 experts) and router, read back with
    ``load_artifacts``, at seq 128; 96 unique corpus prompts, 64 exact
    repeats, 96 paraphrases (one token of an earlier prompt replaced),
    the four-flag mix.  Engines: a fresh-scoring oracle (no cache), the
    exact tier alone, every tier (a ``DiskKVStore`` in a temporary
    directory plus T3 at an eps calibrated on the card's embeddings),
    and a restart over the same directory; then the tiered engine's
    routing again on the CPU.  Returns the phase's line.

    ``bench_cache`` fails on any wrong routing.  Here that holds for
    the exact tiers and fresh scores only: eps bounds the distance
    between the unique prompts' disagreeing verdicts, not the distance
    from a paraphrase to a decision boundary, so T3 may hand a
    paraphrase its neighbour's verdict where a fresh score differs.
    Those rows are counted (``wrong_t3``) and listed with their oracle
    gap and squared distance over eps squared."""
    import shutil
    import tempfile

    from repro_torch.core import experiment as ex
    from repro_torch.core.objective import (constraint_matrix,
                                            recency_constraint,
                                            size_constraint)
    from repro_torch.data.corpus import N_SPECIAL
    from repro_torch.kernels import launches
    from repro_torch.kernels.router_score import ops as rs_ops
    from repro_torch.serving import (Request, TryageEngine, calibrate_eps,
                                     lambda_matrix)
    from repro_torch.serving.engine import EngineStats

    art = ex.load_artifacts()
    lib, rp, rc, corpus = (art["library"], art["router_params"], art["rc"],
                           art["corpus"])
    cons = [size_constraint(lib), recency_constraint(lib)]
    cnames = [c.name for c in cons]
    cmat = constraint_matrix(cons, len(lib))
    flag_mix = [{}, {"size": 1.0}, {"size": 8.0}, {"recency": 2.0}]
    rng = np.random.default_rng(0)
    toks, _ = corpus.sample_mixture({d: 1.0 / 8 for d in corpus.tables},
                                    CT_UNIQUE, SEQ, rng)
    para = toks[np.arange(CT_PARA) % CT_UNIQUE].copy()
    for i in range(CT_PARA):           # paraphrase: replace one token
        para[i, rng.integers(0, SEQ)] = rng.integers(N_SPECIAL,
                                                     corpus.vocab_size)
    stream = ([toks[i] for i in range(CT_UNIQUE)]
              + [toks[i % CT_UNIQUE] for i in range(CT_REPEAT)]
              + [para[i] for i in range(CT_PARA)])
    n = len(stream)

    def workload():
        return [Request(uid=i, tokens=t, lambdas=flag_mix[i % 4])
                for i, t in enumerate(stream)]

    def engine(library=lib, router=rp, device="cuda", **kw):
        return TryageEngine(library, router, rc, cons, max_batch=MAX_BATCH,
                            device=device, **kw)

    def run_measured(eng):
        """bench_cache's measurement: a warm-up run of 8 other prompts,
        the cache's in-memory tiers cleared and the stats reset, then
        the stream, with the tier of every row logged."""
        warm = rng.integers(N_SPECIAL, corpus.vocab_size, size=(8, SEQ))
        for i in range(8):
            eng.submit(Request(uid=-1 - i, tokens=warm[i].astype(np.int32)))
        eng.run()
        if eng.cache is not None:
            eng.cache.clear()
        eng.stats = EngineStats()
        log = TierLog(eng) if eng.cache is not None else None
        for r in workload():
            eng.submit(r)
        t0 = time.perf_counter()
        out = {r.uid: r for r in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(sorted(out) == list(range(n)), "not one Result per request")
        return out, log, wall

    reqs = workload()
    oracle_eng = engine(decision_cache=False)
    oracle, _, oracle_wall = run_measured(oracle_eng)
    gaps = {}
    for u, r in oracle.items():
        sc = np.sort(r.pred_losses + lambda_matrix([reqs[u]], cnames)[0]
                     @ cmat)
        gaps[u] = float(sc[1] - sc[0])

    # eps per context on the card's embeddings of the unique prefix
    uniq = reqs[:CT_UNIQUE]
    emb = oracle_eng._embed_batch(uniq)
    choices = np.array([oracle[r.uid].expert for r in uniq])
    ctx = np.arange(CT_UNIQUE) % 4
    eps = min(calibrate_eps(emb[ctx == c], choices[ctx == c], margin=0.5)
              for c in range(4))
    eps_rule = "0.5x the closest same-context disagreeing pair"
    if not np.isfinite(eps):           # every verdict agrees
        d = ((emb[:, None] - emb[None]) ** 2).sum(-1)
        eps = 0.5 * float(np.sqrt(np.median(d[d > 0])))
        eps_rule = "0.5x the median pairwise distance (no disagreeing pair)"

    def measure(tag, eng):
        """Serve the stream; the phase's numbers for ``eng``, and each
        row's Result, tier and T3 distance.  A row is wrong where its
        expert is not the oracle's; excused where the oracle's top-two
        gap is under CHOICE_GAP."""
        out, log, wall = run_measured(eng)
        st = eng.stats
        tiers, d2 = log.rows(n)
        wrong = [u for u in out if out[u].expert != oracle[u].expert]
        tied = [u for u in wrong if gaps[u] < CHOICE_GAP]
        line = {"hit_rate": st.cache_hit_rate,
                "tiers": {k: int(v) for k, v in
                          sorted(st.cache_tier_hits.items())},
                "revalidations": st.cache_revalidations,
                "revalidation_rejects": st.cache_revalidation_rejects,
                "router_batches": st.router_batches,
                "router_ms_per_request": 1e3 * st.router_time_s / n,
                "wall_s": wall, "wrong": len(wrong),
                "near_tie_excused": len(tied),
                "wrong_t3": sum(tiers[u] == "t3" for u in wrong
                                if u not in tied),
                "wrong_rows": [
                    {"uid": u, "tier": tiers[u], "served": out[u].expert,
                     "oracle": oracle[u].expert, "oracle_gap": gaps[u],
                     "d2_over_eps2": (None if d2[u] is None
                                      else d2[u] / eps ** 2)}
                    for u in wrong]}
        return line, out, tiers, d2, [u for u in wrong if u not in tied]

    # exact tiers answer only byte-identical requests: no wrong routing
    exact, _, _, _, bad = measure("exact", engine())
    check(not bad, f"exact: wrong routings against the oracle, uids {bad}")
    tmp = tempfile.mkdtemp(prefix="cache_tiers_")
    try:
        tiered_eng = engine(cache_dir=os.path.join(tmp, "card"),
                            cache_semantic_eps=eps)
        scored = {"calls": 0, "router_score": 0}
        inner = tiered_eng._score_from_emb

        def score_from_emb(reqs_, emb_):
            before = rs_ops.router_score_fused.launches
            out = inner(reqs_, emb_)
            scored["calls"] += 1
            scored["router_score"] += (rs_ops.router_score_fused.launches
                                       - before)
            return out

        tiered_eng._score_from_emb = score_from_emb
        launches.reset_launch_counts()
        tiered, t_out, t_tiers, t_d2, bad = measure("tiered", tiered_eng)
        counts = launches.launch_counts()
        # T3 answers a paraphrase with its neighbour's verdict: the only
        # rows that may differ from a fresh score (reported, see wrong_t3)
        check(all(t_tiers[u] == "t3" for u in bad),
              f"tiered: wrong routings outside T3, uids "
              f"{[u for u in bad if t_tiers[u] != 't3']}")
        check(scored["calls"] > 0 and scored["router_score"] > 0,
              f"the T3 path launched no router_score: {scored}")
        stale = sorted(tiered_eng.cache.stale_versions(
            tiered_eng.router_version))
        tiered_eng.cache.close()
        restart_eng = engine(cache_dir=os.path.join(tmp, "card"),
                             cache_semantic_eps=eps)
        restart, r_out, _, _, _ = measure("restart", restart_eng)
        moved = [u for u in range(n) if r_out[u].expert != t_out[u].expert]
        check(not moved, f"restart: verdicts differ from the tiered "
                         f"run's, uids {moved}")
        stale += sorted(restart_eng.cache.stale_versions(
            restart_eng.router_version))
        restart_eng.cache.close()
        check(restart["hit_rate"] >= 0.99
              and set(restart["tiers"]) <= {"t1", "t2"},
              f"restart: hit rate {restart['hit_rate']}, tiers "
              f"{restart['tiers']}")
        check(not stale, f"stale router versions in the cache: {stale}")

        # the tiered engine's routing again on the CPU, same weights
        lib_cpu = copy.deepcopy(lib)
        for e in lib_cpu.experts:
            e.params.cpu()
        cpu_eng = engine(lib_cpu, copy.deepcopy(rp).cpu(), "cpu",
                         cache_dir=os.path.join(tmp, "cpu"),
                         cache_semantic_eps=eps)
        log = TierLog(cpu_eng)
        cpu_choice = []
        for k in range(0, n, MAX_BATCH):
            ctx_ = cpu_eng.pipeline.admit(workload()[k:k + MAX_BATCH])
            cpu_choice += [lib[int(c)].name for c in ctx_.choice]
        cpu_eng.cache.close()
        c_tiers, c_d2 = log.rows(n)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    differ, boundary, tied = [], 0, 0
    for u in range(n):
        if (t_tiers[u], t_out[u].expert) == (c_tiers[u], cpu_choice[u]):
            continue
        differ.append(u)
        ds = [x for x in (t_d2[u], c_d2[u]) if x is not None]
        if any(abs(x - eps ** 2) <= 1e-4 * eps ** 2 for x in ds):
            boundary += 1
        elif gaps[u] < CHOICE_GAP:
            tied += 1
    check(len(differ) == boundary + tied,
          f"card and CPU tiered engines differ on uids {differ}")
    out = {"requests": n, "unique": CT_UNIQUE, "repeats": CT_REPEAT,
           "paraphrases": CT_PARA, "seq": SEQ, "experts": len(lib),
           "eps": eps, "eps_rule": eps_rule,
           "oracle": {"router_ms_per_request":
                      1e3 * oracle_eng.stats.router_time_s / n,
                      "wall_s": oracle_wall},
           "exact": exact, "tiered": tiered, "restart": restart,
           "hit_rate_ratio": tiered["hit_rate"] / max(exact["hit_rate"],
                                                      1e-9),
           "launches": counts, "t3_scoring": scored,
           "stale_versions": stale,
           "cpu_rerun": {"rows": n, "differ": differ,
                         "eps_boundary_excused": boundary,
                         "near_tie_excused": tied,
                         "tiers": {t: c_tiers.count(t)
                                   for t in sorted(set(c_tiers))}}}
    emit("cache_tiers", **out)
    return out


def serve_cli_phase(torch, eps: float) -> dict:
    """``python -m repro_torch.launch.serve``'s ``main`` three times over
    ``train_path``'s artifacts: (A) every cache tier in a temporary
    directory, 600 req/s Poisson arrivals over 4 sessions, the fused
    cascade; (B) the same again, a restart over the same directory;
    (C) the FIFO drain with the exact tier, closed loop.  Each run's
    summary JSON goes to ``chiprun_out/serve_cli_<run>.json``."""
    import io
    import shutil
    import tempfile

    from repro_torch.kernels import launches
    from repro_torch.launch import serve as cli

    tmp = tempfile.mkdtemp(prefix="serve_cli_")
    base = ["--requests", str(N_REQUESTS), "--cascade", "0.6",
            "--fused-cascade"]
    tiered = base + ["--cache-tiers", "exact,persistent,semantic",
                     "--cache-dir", os.path.join(tmp, "t2"),
                     "--cache-semantic", repr(eps),
                     "--arrival-rate", str(CLI_RATE), "--sessions", "4"]
    runs = {"A": tiered, "B": tiered, "C": ["--fifo"] + base}
    out = {}
    try:
        for name, argv in runs.items():
            metrics = os.path.join(tmp, f"{name}.prom")
            printed = io.StringIO()
            launches.reset_launch_counts()
            with contextlib.redirect_stdout(printed):
                summary = cli.main(argv + ["--metrics-out", metrics])
            counts = launches.launch_counts()
            with open(metrics) as f:
                text = f.read()
            OUT_DIR.mkdir(exist_ok=True)
            (OUT_DIR / f"serve_cli_{name}.json").write_text(
                json.dumps(summary, indent=1))
            eng = summary["engine"]
            check(summary["requests"] == N_REQUESTS
                  and eng["fallback"]["failed"] == 0
                  and eng["frontend"]["shed"] == 0
                  and np.isfinite(summary["mean_mlm_loss"]),
                  f"run {name}: {summary['requests']} served, "
                  f"{eng['fallback']['failed']} failed, loss "
                  f"{summary['mean_mlm_loss']}")
            check(summary["device"].startswith("cuda"),
                  f"run {name} served on {summary['device']}")
            check(counts["flash_attention"] > 0,
                  f"run {name}: flash_attention not launched {counts}")
            out[name] = {"argv": argv, "req_per_s": summary["req_per_s"],
                         "wall_s": summary["wall_s"],
                         "latency": eng["latency"],
                         "cache": eng["cache"], "flushes": eng["flushes"],
                         "escalations": eng["cascade"]["escalations"],
                         "router_batches": eng["router_batches"],
                         "mean_mlm_loss": summary["mean_mlm_loss"],
                         "launches": counts,
                         "t2_series": [ln for ln in text.splitlines()
                                       if ln.startswith(
                                           "tryage_cache_tier_hits_total{")]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b = out["B"]["cache"]
    check(b["hit_rate"] >= 0.99 and b["tiers"].get("t2", 0) > 0,
          f"restart: hit rate {b['hit_rate']}, tiers {b['tiers']}")
    check(any('tier="t2"' in ln for ln in out["B"]["t2_series"]),
          "the restart's metrics carry no t2 hits")
    check(out["A"]["launches"]["router_score"] > 0
          and out["C"]["launches"]["router_cascade"] > 0,
          "router_score (run A's T3 path) or router_cascade (run C) "
          "not launched")
    emit("serve_cli", arrival_rate=CLI_RATE, eps=eps, runs=out)
    return out


# -------------------------------------------------------------- phase 5

def device_profile(torch, fn, wall_ms, top=8, match=None,
                   host=True) -> dict:
    """Kernel time on the card for one call of ``fn`` under the
    profiler, with the top kernels, and for each ``match`` entry (name:
    a substring, or a tuple of them) the time of the kernels whose names
    hold one.
    ``busy_share`` is the device time over ``wall_ms``, the timed
    (unprofiled) run of the same work.  The profiled wall time includes
    the profiler's own start-up and is reported only as such.  Where the
    trace shows no device time at all (the profiler could not trace the
    card), every device figure is None: not measured, rather than an
    idle card.  ``host=False`` traces the card alone (no CPU-side op
    events): for a step of some 300,000 launches (xlstm's training
    step) the host events would cost minutes to collect and add up."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    acts = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")
         and e.self_device_time_total > 0), key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels) or None
    out = {"profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy,
           "busy_share": busy / wall_ms if busy else None,
           "top_kernels": [{"name": n[:80], "ms": t, "count": c}
                           for n, t, c in kernels[:top]]}
    for name, sub in (match or {}).items():
        subs = (sub,) if isinstance(sub, str) else sub
        ms = (sum(t for n, t, _ in kernels if any(x in n for x in subs))
              if busy else None)
        out[f"{name}_ms"] = ms
        out[f"{name}_share"] = ms / busy if busy else None
    return out


def events_ms(torch, fn, iters=200, warmup=20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_kernels(torch, fn, iters=50, host=True) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` runs, over
    ``iters`` calls under the profiler (``host=False``: the card's
    activity alone, as ``device_profile``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    acts = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        if evt.self_device_time_total:
            out[evt.key] = (out.get(evt.key, 0.0)
                            + evt.self_device_time_total / iters / 1e3)
    return out


def profiled_ms(torch, fn, kernel: str, iters=50, host=True):
    """Device time per call of the CUDA kernels whose names hold
    ``kernel`` (all of a wrapper's launches), from the profiler's trace;
    None if the trace shows no device time for them."""
    ms = sum(t for n, t in profiled_kernels(torch, fn, iters, host).items()
             if kernel in n)
    return ms or None


def times_phase(torch, launches_per_run: dict, err: dict,
                bwd_per_step: int, zoo_per_step: dict) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm_scan import ops as ml_ops
    from repro_torch.kernels.router_cascade import ops as rc_ops
    from repro_torch.kernels.router_score import ops as rs_ops

    B, d, hh, M, n_c = 32, 128, 128, 11, 2
    t = head_inputs(torch, B, M, d, hh, n_c, seed=1)
    sa = [t[k] for k in SCORE_ARGS]
    ca = [t[k] for k in CASCADE_ARGS]
    shape = {"B": B, "d": d, "hh": hh, "M": M, "n_c": n_c}
    rows = [
        ("router_score", lambda: rs_ops.router_score_fused(*sa),
         lambda: rs_ops.router_score_plain(*sa), None,
         *head_cost(B, d, hh, M, n_c, cascade=False), shape, None),
        ("router_cascade", lambda: rc_ops.router_score_cascade_fused(*ca),
         lambda: rc_ops.router_cascade_plain(*ca), None,
         *head_cost(B, d, hh, M, n_c, cascade=True), shape, None),
    ]
    B, S, H, dh = XLSTM_B, XLSTM_S, 4, 1024
    L = min(64, S)
    ml_args = mlstm_inputs(torch, B, S, H, dh, False, seed=2)
    rows.append(("mlstm_scan", lambda: ml_ops.mlstm_chunkwise(*ml_args),
                 lambda: ml_ops.mlstm_chunkwise_plain(*ml_args), None,
                 # q, k, v, h; C0, C1; n0, n1; i, f; m0, m1
                 4 * (4 * B * S * H * dh + 2 * B * H * dh * dh
                      + 2 * B * H * dh + 2 * B * S * H + 2 * B * H),
                 # per row and chunk: q k^T and (W*S) v, q C and k^T v
                 B * H * (S // L) * (4 * L * L * dh + 4 * L * dh * dh),
                 {"B": B, "S": S, "H": H, "dh": dh, "chunk": L}, None))
    # the mLSTM backward at xlstm-1.3b's training shape (2 x 512): from the
    # forward kernel's chunk-start states; no library call computes it
    B, S = 2, 512
    nc = S // L
    q, k, v, i, f, st = mlstm_inputs(torch, B, S, H, dh, False, seed=3)
    dh_ = torch.randn(B, S, H, dh, device="cuda")
    h, _, states = ml_ops._launch(q, k, v, i, f, st, True)
    bwd_args = (q, k, v, i, f, st)     # bound now: i is reused below
    rows.append(("mlstm_scan_bwd",
                 lambda a=bwd_args, h=h, d=dh_, s=states:
                 ml_ops.mlstm_chunkwise_bwd(*a, h, d, s),
                 lambda a=bwd_args, d=dh_:
                 ml_ops.mlstm_chunkwise_grad_plain(*a, d), None,
                 # q, k, v, h, dh read and dq, dk, dv written; i, f read
                 # and di, df written; the chunk-start states read; m0
                 4 * (8 * B * S * H * dh + 4 * B * S * H
                      + B * H * nc * (dh * dh + dh) + B * H),
                 # per row and chunk: C dnum, G v, G^T k and the
                 # recurrence's (aq)^T dnum (2 L dh^2 each); q k^T,
                 # dnum v^T, dS k, dS^T q, P^T dnum (2 L^2 dh each)
                 B * H * nc * (8 * L * dh * dh + 10 * L * L * dh),
                 {"B": B, "S": S, "H": H, "dh": dh, "chunk": L}, None))
    extra = []
    # the main path's shape first, then hd 40, 8 heads, and the batch
    # sizes most of run()'s launches take (1 to 8)
    for i, (Bq, H, hd) in enumerate(((32, 4, 32), (32, 4, 40), (32, 8, 32),
                                     (1, 4, 32), (8, 4, 32))):
        g = torch.Generator(device="cuda").manual_seed(H * hd)
        q, k, v = (torch.randn(Bq, 128, H, hd, device="cuda", generator=g)
                   for _ in range(3))
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        case = ("flash_attention", (lambda q=q, k=k, v=v:
                                     fa_ops.flash_attention(q, k, v,
                                                            causal=False)),
                (lambda q=q, k=k, v=v:
                 fa_ops.attention_plain(q, k, v, causal=False)),
                (lambda qh=qh, kh=kh, vh=vh:
                 F.scaled_dot_product_attention(qh, kh, vh)),
                4 * 4 * Bq * 128 * H * hd, 4 * Bq * H * 128 * 128 * hd,
                {"B": Bq, "H": H, "S": 128, "hd": hd, "causal": False},
                (lambda q=q, k=k, v=v, qh=qh, kh=kh, vh=vh: float((
                    F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2)
                    - fa_ops.attention_plain(q, k, v, causal=False))
                    .abs().max())))
        (rows if i == 0 else extra).append(case)
    # the attention backward at the largest expert's shape, then the
    # specialists' and the router's; SDPA's backward is the library call
    for i, (Bq, H, hd) in enumerate(((16, 8, 32), (16, 4, 40), (32, 4, 32))):
        q, k, v, do = attn_grad_inputs(torch, Bq, 128, 128, H, H, hd, hd)
        _, lse = fa_ops._forward(q, k, v, False, 0, 0.0, True)
        qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_(True)
                      for a in (q, k, v))
        with torch.enable_grad():
            oh = F.scaled_dot_product_attention(qh, kh, vh)
        doh = do.transpose(1, 2).contiguous()
        case = ("flash_attention_bwd",
                (lambda q=q, k=k, v=v, lse=lse, do=do:
                 fa_ops.flash_attention_bwd(q, k, v, lse, do,
                                            causal=False)),
                (lambda q=q, k=k, v=v, do=do:
                 fa_ops.attention_grad_plain(q, k, v, do, causal=False)),
                (lambda oh=oh, qh=qh, kh=kh, vh=vh, doh=doh:
                 torch.autograd.grad(oh, (qh, kh, vh), doh,
                                     retain_graph=True)),
                # q, k, v, dO and the log-sum-exp read; dQ, dK, dV written
                7 * 4 * Bq * 128 * H * hd + 4 * Bq * H * 128,
                10 * Bq * H * 128 * 128 * hd,
                {"B": Bq, "H": H, "S": 128, "hd": hd, "causal": False},
                (lambda q=q, k=k, v=v, do=do, oh=oh, qh=qh, kh=kh, vh=vh,
                 doh=doh: max(float((a.transpose(1, 2) - w).abs().max())
                              for a, w in zip(torch.autograd.grad(
                                  oh, (qh, kh, vh), doh, retain_graph=True),
                                  fa_ops.attention_grad_plain(
                                      q, k, v, do, causal=False)))))
        (rows if i == 0 else extra).append(case)
    kernels, extra_out = [], []
    for n, (name, kern, plain, libcall, nbytes, flops, shape,
            lib_err) in enumerate(rows + extra):
        bms, by = bound_ms(nbytes, flops)
        entry = {"name": name, "route": "cuda", "source": SOURCES[name][0],
                 "replaces": SOURCES[name][1],
                 "launches": launches_per_run[name],
                 "max_abs_err": err[name],
                 "ms": events_ms(torch, kern),
                 "device_ms": profiled_ms(torch, kern, SOURCES[name][2]),
                 "plain_ms": events_ms(torch, plain),
                 "bound_ms": bms, "bound_by": by,
                 "library_ms": (events_ms(torch, libcall)
                                if libcall is not None else None),
                 "shape": shape}
        if name in TENSOR_CORE:
            entry["bound_tc_ms"], entry["bound_tc_by"] = bound_ms(
                nbytes, 3 * flops, TF32_TC_FLOPS_PER_S)
        if name == "flash_attention_bwd":
            entry["launches_per_expert_step"] = bwd_per_step
        if name == "mlstm_scan_bwd":
            entry["launches_per_xlstm_step"] = zoo_per_step[name]
        if libcall is not None:
            # the library call's own kernels, device time and error
            lib_k = profiled_kernels(torch, libcall)
            entry["library_kernel"] = (max(lib_k, key=lib_k.get)[:80]
                                       if lib_k else None)
            entry["library_device_ms"] = sum(lib_k.values()) or None
            entry["library_max_abs_err"] = lib_err()
        (kernels if n < len(rows) else extra_out).append(entry)
    emit("times", kernels=kernels, extra_shapes=extra_out,
         zoo_prefill_attention=zoo_attention_times(torch, F, fa_ops),
         zoo_train_attention_bwd=zoo_attention_bwd_times(torch, F, fa_ops),
         launch_floor=launch_floor(torch, rs_ops.decision_plan(32, d, hh)),
         router_buckets=router_buckets(
             torch, rs_ops, rc_ops, d, hh, M, n_c),
         method="ms/plain_ms/library_ms: CUDA events over 200 back-to-back "
                "calls after 20 warm-up calls; device_ms/library_device_ms: "
                "profiler device time of the call's kernels alone "
                "(null where the profiler's trace shows none); "
                "library_max_abs_err: the library call against the plain "
                "version; launch_floor: an empty kernel through the "
                "wrappers' launch path, at one warp and at the "
                "router_score grid and block for B=32; "
                "zoo_prefill_attention: the same over 20 calls after 3 "
                "(the plain version 3 after 1), bound at the bf16 tensor "
                "cores' rate for the pairs the masks leave")
    return kernels


def attention_pairs(S, causal, window) -> int:
    """(query, key) pairs that the masks leave, for S queries over S keys:
    the work a causal or window call's data needs."""
    total = 0
    for row in range(S):
        lo = max(0, row - window + 1) if window > 0 else 0
        hi = row + 1 if causal else S
        total += max(0, hi - lo)
    return total


def zoo_attention_times(torch, F, fa_ops) -> list:
    """The attention kernel at the zoo decoders' bf16 prefill shapes:
    CUDA events and profiler device time beside the plain version,
    SDPA on the same bf16 inputs and mask (its K/V repeated to H heads
    and transposed to (B, H, S, hd) beforehand), and the bound: bytes
    (q, k, v read, o written) over 3.35 TB/s or the unmasked pairs'
    4 hd operations a head over the bf16 tensor cores' 989 TFLOP/s,
    the larger.  SDPA rounds P to bf16 for its P V product; the kernel
    keeps P in f32 (two TF32 passes).  SDPA has no softcap: at grok's
    shape (softcap 30) it computes attention without one, so its time is
    beside the kernel's but its error is taken against the plain version
    without softcap."""
    out = []
    for B, S, H, KV, hd, causal, window, softcap, label in ZOO_TIMES:
        g = torch.Generator(device="cuda").manual_seed(S + hd)
        q = torch.randn(B, S, H, hd, device="cuda", generator=g).bfloat16()
        k, v = (torch.randn(B, S, KV, hd, device="cuda", generator=g)
                .bfloat16() for _ in range(2))
        qh = q.transpose(1, 2).contiguous()
        kh, vh = (a.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous() for a in (k, v))
        mask = None
        if window > 0:
            i = torch.arange(S, device="cuda")
            mask = ((i[None, :] <= i[:, None]) if causal else True) & (
                i[None, :] > i[:, None] - window)

        def sdpa(qh=qh, kh=kh, vh=vh, mask=mask, causal=causal):
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask,
                is_causal=causal and mask is None)

        def kern(q=q, k=k, v=v, causal=causal, window=window,
                 softcap=softcap):
            return fa_ops.flash_attention(q, k, v, causal=causal,
                                          window=window, softcap=softcap)

        def plain(q=q, k=k, v=v, causal=causal, window=window,
                  softcap=softcap):
            return fa_ops.attention_plain(q, k, v, causal=causal,
                                          window=window, softcap=softcap)

        ref = plain().float()
        lib_ref = plain(softcap=0.0).float() if softcap else ref
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        flops = 4 * B * H * hd * attention_pairs(S, causal, window)
        bms, by = bound_ms(nbytes, flops, BF16_TC_FLOPS_PER_S)
        lib_k = profiled_kernels(torch, sdpa)
        out.append({
            "config": label, "dtype": "bfloat16",
            "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                      "causal": causal, "window": window,
                      "softcap": softcap},
            "ms": events_ms(torch, kern, iters=20, warmup=3),
            "device_ms": profiled_ms(torch, kern, SOURCES[
                "flash_attention"][2], iters=10),
            "plain_ms": events_ms(torch, plain, iters=3, warmup=1),
            "library_ms": events_ms(torch, sdpa, iters=20, warmup=3),
            "library_device_ms": sum(lib_k.values()) or None,
            "library_kernel": (max(lib_k, key=lib_k.get)[:80]
                               if lib_k else None),
            "bound_ms": bms, "bound_by": by,
            "max_abs_err": float((kern().float() - ref).abs().max()),
            "library_max_abs_err": float(
                (sdpa().transpose(1, 2).float() - lib_ref).abs().max())})
        del q, k, v, qh, kh, vh, mask, ref, lib_ref
        torch.cuda.empty_cache()
    return out


def zoo_attention_bwd_times(torch, F, fa_ops) -> list:
    """The attention backward at the zoo's bf16 training shapes
    (ZOO_ATTN_GRAD): CUDA events and profiler device time beside the
    plain version's autograd, SDPA's backward on the same bf16 inputs
    and mask (K/V repeated to H heads and transposed beforehand, the
    forward outside the timing), and the bound: bytes (q, k, v, dO read,
    dQ, dK, dV written in bf16; lse read in f32) over 3.35 TB/s or the
    five products' 10 hd operations a head for each pair the masks
    leave over the bf16 tensor cores' 989 TFLOP/s, the larger."""
    out = []
    for B, S, H, KV, hd, causal, window, label in ZOO_ATTN_GRAD:
        q, k, v, do = (x.bfloat16() for x in attn_grad_inputs(
            torch, B, S, S, H, KV, hd, S + hd))
        masks = dict(causal=causal, window=window, softcap=0.0)
        _, lse = fa_ops._forward(q, k, v, causal, window, 0.0, True)
        qh, kh, vh = (a.repeat_interleave(H // a.shape[2], dim=2)
                      .transpose(1, 2).contiguous().requires_grad_(True)
                      for a in (q, k, v))
        mask = None
        if window > 0:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :]
                                                  > i[:, None] - window)
        with torch.enable_grad():
            oh = F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None)
        doh = do.transpose(1, 2).contiguous()

        def kern(q=q, k=k, v=v, lse=lse, do=do, masks=masks):
            return fa_ops.flash_attention_bwd(q, k, v, lse, do, **masks)

        def plain(q=q, k=k, v=v, do=do, masks=masks):
            return fa_ops.attention_grad_plain(q, k, v, do, **masks)

        def sdpa(oh=oh, qh=qh, kh=kh, vh=vh, doh=doh):
            return torch.autograd.grad(oh, (qh, kh, vh), doh,
                                       retain_graph=True)

        # q, dO, dQ at q's size; k, v, dK, dV at k's; lse in f32
        nbytes = 2 * (3 * B * S * H * hd + 4 * B * S * KV * hd) \
            + 4 * B * H * S
        flops = 10 * B * H * hd * attention_pairs(S, causal, window)
        bms, by = bound_ms(nbytes, flops, BF16_TC_FLOPS_PER_S)
        lib_k = profiled_kernels(torch, sdpa, iters=5, host=False)
        out.append({
            "config": label, "dtype": "bfloat16",
            "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                      "causal": causal, "window": window},
            "kernel_launches": fa_ops.backward_launches(S, hd),
            "ms": events_ms(torch, kern, iters=10, warmup=2),
            "device_ms": profiled_ms(torch, kern, SOURCES[
                "flash_attention_bwd"][2], iters=5, host=False),
            "plain_ms": events_ms(torch, plain, iters=2, warmup=1),
            "library_ms": events_ms(torch, sdpa, iters=10, warmup=2),
            "library_device_ms": sum(lib_k.values()) or None,
            "library_kernel": (max(lib_k, key=lib_k.get)[:80]
                               if lib_k else None),
            "bound_ms": bms, "bound_by": by})
        del q, k, v, do, lse, qh, kh, vh, oh, doh, mask
        torch.cuda.empty_cache()
    return out


def head_cost(B, d, hh, M, n_c, cascade) -> tuple[int, int]:
    """(bytes, f32 operations) of one router-head call: weights, rows
    and outputs moved once; both layers' products and the constraint
    add."""
    heads = 2 if cascade else 1
    head_bytes = 4 * (d * hh + hh + hh * M + M)
    io_bytes = 4 * (B * d + n_c * M + B * n_c + B * M + B)
    if cascade:     # sigma, esc, ladder_pos
        io_bytes += 4 * (B * M + B + M)
    head_flops = 2 * B * d * hh + 2 * B * hh * M
    return heads * head_bytes + io_bytes, (heads * head_flops
                                           + 2 * B * n_c * M)


def launch_floor(torch, plan: dict) -> dict:
    """Events and device time of the empty kernel ``launch_floor_kernel``
    (``csrc/launch_floor.cu``) launched through ``build.launch``: one
    block of one warp, and the grid and block of ``plan`` (a router
    kernel's launch at B=32)."""
    from repro_torch.kernels import build
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"source": "src/repro_torch/kernels/csrc/launch_floor.cu"}
    for key, grid, threads in (("one_warp", 1, 32),
                               ("b32", plan["grid"], plan["threads"])):
        fn = (lambda grid=grid, threads=threads:
              build.launch("tryage_launch_floor", dev, grid, threads))
        out[key] = {"grid": grid, "threads": threads,
                    "ms": events_ms(torch, fn),
                    "device_ms": profiled_ms(torch, fn,
                                             "launch_floor_kernel")}
    return out


def router_buckets(torch, rs_ops, rc_ops, d, hh, M, n_c) -> list:
    """Both router heads at every bucket size ``run()`` launches them
    at: events and device time beside the bound and the launch plan."""
    out = []
    for B in (1, 2, 4, 8, 16, 32):
        t = head_inputs(torch, B, M, d, hh, n_c, seed=B)
        row = {"B": B}
        for name, fn, args, cascade in (
                ("router_score", rs_ops.router_score_fused, SCORE_ARGS,
                 False),
                ("router_cascade", rc_ops.router_score_cascade_fused,
                 CASCADE_ARGS, True)):
            call = (lambda fn=fn, a=[t[k] for k in args]: fn(*a))
            bms, _ = bound_ms(*head_cost(B, d, hh, M, n_c, cascade))
            plan = (rc_ops.decision_plan(B, d, hh) if cascade
                    else rs_ops.decision_plan(B, d, hh))
            row[name] = {"ms": events_ms(torch, call),
                         "device_ms": profiled_ms(torch, call,
                                                  SOURCES[name][2]),
                         "bound_ms": bms, "threads": plan["threads"],
                         "k_groups": plan["k_groups"]}
        out.append(row)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from the root of "
              "a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    info = device_phase(torch)
    build_phase()
    err = parity_phase(torch)
    setup = main_setup(torch)
    main, run_res = main_path_phase(torch, setup)
    serve_path_phase(torch, setup, run_res, main, info["nvidia_smi"])
    xlstm, corpus = xlstm_serve_phase(torch)
    xlstm_crosscheck_phase(torch, corpus)
    zoo_serve_phase(torch)
    zoo_crosscheck_phase(torch)
    err["flash_attention_bwd"] = attention_grad_phase(torch)
    err["mlstm_scan_bwd"] = mlstm_grad_phase(torch)
    zoo_launches = zoo_train_phase(torch)
    zoo_train_crosscheck_phase(torch)
    train_cli_phase(torch)
    train = train_path_phase(torch)
    adapt_path_phase(torch)
    tiers = cache_tiers_phase(torch)
    serve_cli_phase(torch, tiers["eps"])
    # launches of each kernel in the run of the path that uses it
    path_launches = {n: main["launches"][n] for n in ROUTER_PATH}
    path_launches["mlstm_scan"] = xlstm["launches"]["mlstm_scan"]
    path_launches["flash_attention_bwd"] = (
        train["launches"]["flash_attention_bwd"])
    # the mLSTM backward's path is zoo_train (xlstm-1.3b's steps)
    path_launches["mlstm_scan_bwd"] = zoo_launches["mlstm_scan_bwd"]
    kernels = times_phase(torch, path_launches, err,
                          train["attention_bwd_per_expert_step"],
                          {"mlstm_scan_bwd": zoo_launches["mlstm_scan_bwd"]
                           // TRAIN_STEPS})
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k != "shape"} for e in kernels]}),
        flush=True)
    emit("done", seconds=time.perf_counter() - t0)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
