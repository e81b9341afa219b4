"""Worker of ``tests/test_torch_sharded_step.py``: one rank of a gloo
group on the CPU runs the sharded train, prefill and decode steps of a
tiny model and holds them to the meshless steps from the same weights.
``check_steps`` runs on an NCCL rank per card too
(``scripts/sharded_steps_cards.py``).

Every rank draws the same weights and batch from the seed, runs the
meshless steps itself, and checks its gathered sharded results against
them; a failed check raises, which fails the spawn."""

import copy
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels import launches
from repro_torch.launch import steps
from repro_torch.launch.mesh import device_mesh, make_host_mesh
from repro_torch.models import model as tm
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import adamw_init

#: relative tolerance (of the largest reference value) of the sharded
#: step against the meshless one in f32: DTensor sums partial products
#: and partial norms across ranks in another order than one device
#: does; the gradients (read through the AdamW moments: mu, and nu as
#: its root) differ by under 1e-6 on torch 2.13.  On torch 2.11, whose
#: DTensor orders some sums otherwise, nu itself of the Mamba case's
#: dt_w differed by 1.18e-5 of its largest value: a square doubles the
#: gradient's relative rounding, so nu is held as its root.  The weights after the step are held to Adam's update of the
#: shared initial weights by the sharded run's own gathered moments:
#: Adam's first step moves each weight by lr g / (|g| + eps), so
#: against the meshless weights a weight whose gradient is near eps
#: takes the gradients' rounding amplified (a few such weights of the
#: MoE case differ by 3-5% of lr).
RTOL = 1e-5
#: the reduced xLSTM's: sums in another order through its 8 recurrent
#: layers move its states and gradients by up to about 1.1e-4 of their
#: largest value (my runs: (2, 2) and (1, 4) meshes, torch 2.13); the
#: port is held to the reference there at atol 5e-4 on values near 1
#: (tests/test_torch_xlstm.py) for the same reason
RTOL_XLSTM = 5e-4
LR = 5e-5                 # train_step's default, the reference's


def tiny_config(case: str) -> ModelConfig:
    """A 2-layer d-64 f32 decoder; ``gqa``: 8 query heads and 2 kv
    heads (on a 4-way model axis the query heads shard and the kv heads
    do not)."""
    base = ModelConfig(name=f"tiny-{case}", family="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                       vocab_size=128, tie_embeddings=False,
                       dtype="float32", max_seq_len=256)
    if case == "gqa":
        return dataclasses.replace(base, num_heads=8, num_kv_heads=2)
    if case == "moe":
        return dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(
            d_model=64), name="tiny-moe", vocab_size=128)
    if case == "xlstm":
        return dataclasses.replace(get_config("xlstm-1.3b").reduced(
            d_model=64), name="tiny-xlstm", vocab_size=128)
    if case == "mamba":
        return dataclasses.replace(get_config("jamba-v0.1-52b").reduced(
            num_layers=8, d_model=64), name="tiny-mamba", vocab_size=128)
    return base


def _close(name, got, want, rtol=None, scale=None):
    rtol = rtol or (RTOL_XLSTM if _CASE[0] == "xlstm" else RTOL)
    got, want = got.detach().double(), want.detach().double()
    if scale is None:
        scale = float(want.abs().max().clamp_min(1e-30))
    err = float((got - want).abs().max()) / scale
    if not err <= rtol:
        raise AssertionError(f"{name}: max |diff| / max |ref| = {err:.3g} "
                             f"> {rtol}")


def run_rank(rank: int, world: int, store: str, shape, case: str):
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        torch.set_num_threads(1)
        check_steps(shape, case, "cpu")
    finally:
        dist.destroy_process_group()


_CASE = [None]       # the case this rank runs


def check_steps(shape, case: str, dev: str) -> dict:
    """This rank's checks on a ``shape`` mesh of ranks on ``dev``
    (``"cpu"``, or ``"cuda:<rank>"``: rank r on card r).  Returns the
    kernel launches of the sharded train step and prefill, which must
    equal the meshless ones (all 0 on the CPU, where the wrappers run
    their plain versions)."""
    _CASE[0] = case
    world = world_of(shape)
    devices = (["cpu"] * world if dev == "cpu"
               else [f"cuda:{r}" for r in range(world)])
    mesh = device_mesh(make_host_mesh(*shape, devices=devices,
                                      platform=dev.split(":")[0]))
    cfg = tiny_config(case)
    rng = np.random.default_rng(0)
    B, S, steps_ = 4, 16, 4
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.int32)
    batch = {"tokens": tokens, "mask": mask}

    ref = tm.init_model(cfg, seed=3, device=dev)
    model = copy.deepcopy(ref)
    ref_opt = adamw_init(ref)
    p0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
    rules = steps.rules_for(mesh)
    opt = adamw_init(model)              # plain moments, laid out after
    steps.shard_model(model, mesh, rules)
    opt = (steps.shard_opt_state(opt, model) if case == "dense"
           else adamw_init(model))

    counts = {}
    launches.reset_launch_counts()
    want = steps.train_step(ref, ref_opt, batch, lr=LR, device=dev)
    counts["meshless"] = launches.launch_counts()
    launches.reset_launch_counts()
    got = steps.train_step(model, opt, batch, lr=LR, device=dev,
                           mesh=mesh)
    counts["sharded"] = launches.launch_counts()
    _close("loss", got.full_tensor(), want)
    for name, p in ref.named_parameters():
        mu = opt.mu[name].full_tensor()
        nu = opt.nu[name].full_tensor()
        _close(f"mu {name}", mu, ref_opt.mu[name])
        # the second moment as its root, |g| sqrt(1 - b2): a square
        # doubles the gradient's relative rounding
        _close(f"nu {name}", nu.sqrt(), ref_opt.nu[name].sqrt())
        w0 = p0[name].float()
        # AdamW's first step (b1 0.9, b2 0.999, eps 1e-8, decay 1e-5)
        step = (mu / 0.1) / ((nu / 0.001).sqrt() + 1e-8) + 1e-5 * w0
        _close(name, model.get_parameter(name).full_tensor(),
               (w0 - LR * step).to(p.dtype),
               scale=max(float(w0.abs().max()), LR))

    cap = S + steps_
    launches.reset_launch_counts()
    want_l, want_st = steps.prefill_step(ref, {"tokens": tokens},
                                         cache_capacity=cap, device=dev)
    counts["meshless_prefill"] = launches.launch_counts()
    launches.reset_launch_counts()
    got_l, got_st = steps.prefill_step(model, {"tokens": tokens},
                                       cache_capacity=cap, device=dev,
                                       mesh=mesh)
    counts["sharded_prefill"] = launches.launch_counts()
    for k in ("", "_prefill"):
        if counts["sharded" + k] != counts["meshless" + k]:
            raise AssertionError(f"launches{k}: {counts}")
    _close("prefill logits", got_l.full_tensor(), want_l)
    tok_w = want_l.argmax(-1).to(torch.int32)[:, None]
    tok_g = tok_w
    for i in range(steps_):
        tok_w, want_st = steps.serve_step(ref, want_st, tok_w, S + i,
                                          device=dev)
        tok_g, got_st = steps.serve_step(model, got_st, tok_g, S + i,
                                         device=dev, mesh=mesh)
        tok_g = tok_g.full_tensor()
        if not torch.equal(tok_g, tok_w):
            raise AssertionError(f"greedy step {i}: {tok_g.tolist()} != "
                                 f"{tok_w.tolist()}")
    for i, (a, b) in enumerate(zip(got_st, want_st)):
        for k in b:
            _close(f"state {i}.{k}", a[k].full_tensor(), b[k])
    return counts


def world_of(shape) -> int:
    return int(np.prod(shape))
