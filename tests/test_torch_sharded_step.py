"""The sharded train, prefill and decode steps (``launch.steps`` with
``mesh=``) against the meshless steps from the same weights.

``torch.multiprocessing`` spawns 4 ranks on gloo (a ``FileStore`` under
``tmp_path``); each rank draws the same tiny f32 decoder and batch,
runs one ``train_step`` (the loss and both AdamW moments of every
parameter against the meshless step's, every gathered parameter
against Adam's update by those moments), a ``prefill_step`` (last
logits, caches) and 4 greedy ``serve_step``s (identical tokens) both
ways, within ``torch_sharded_util.RTOL`` (1e-5 of the largest reference
value), on (data, model) meshes (2, 2) and (1, 4).  The ``gqa`` case
has 8 query heads and 2 kv heads: on the 4-way model axis the query
heads shard and the kv heads are replicated, so each device's
attention call must take the kv head its own query heads use.  The
``moe`` case (reduced qwen2-moe: 4 experts, one a device) runs the
experts expert-parallel; ``mamba`` (reduced jamba, one 8-layer unit:
Mamba, attention and MoE layers) the Mamba scans on DTensors.  The rest runs in this process:
the kv-head choice, the mesh helpers' refusals, and the fake world.
"""

import os

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_sharded_util as util
from repro_torch.launch import steps
from repro_torch.launch.mesh import (device_mesh, fake_world, make_host_mesh,
                                     production_shape)
from repro_torch.sharding import DEFAULT_RULES, MULTIPOD_RULES
from repro_torch.sharding.local import kv_heads_for
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape,case", [((2, 2), "dense"),
                                        ((1, 4), "gqa"),
                                        ((1, 4), "moe"),
                                        ((2, 2), "mamba")])
def test_sharded_steps_match_meshless(shape, case, tmp_path):
    world = util.world_of(shape)
    mp.spawn(util.run_rank,
             args=(world, os.fspath(tmp_path / "store"), shape, case),
             nprocs=world, join=True)


@pytest.mark.parametrize("h0,n_q,k0,n_kv,group,want", [
    (2, 2, 0, 4, 8, (0, 1)),        # tinyllama on 16: 2 heads, one group
    (8, 8, 0, 4, 8, (1, 1)),
    (0, 4, 0, 4, 1, (0, 4)),        # no grouping
    (4, 4, 2, 2, 2, (0, 2)),        # kv sharded alike: the local groups
    (2, 2, 0, 2, 4, (0, 1)),        # the gqa case on model = 4
    (3, 3, 0, 4, 2, [1, 2, 2]),     # uneven: one kv head a query head
])
def test_kv_heads_for(h0, n_q, k0, n_kv, group, want):
    assert kv_heads_for(h0, n_q, k0, n_kv, group) == want


def test_kv_heads_outside_the_local_block_raise():
    with pytest.raises(ValueError, match="outside"):
        kv_heads_for(8, 2, 0, 1, 4)


def test_device_mesh_refuses_a_repeated_card():
    with pytest.raises(ValueError, match="NCCL cannot place two ranks"):
        device_mesh(make_host_mesh(1, 2, devices=["cuda:0"] * 2))


def test_device_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        device_mesh(make_host_mesh(1, 1, devices=["cpu"], platform="cpu"))


def test_fake_world_opens_and_closes():
    from torch.distributed.device_mesh import init_device_mesh
    dims, names = production_shape(multi_pod=True)
    with fake_world(512):
        assert dist.get_world_size() == 512
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        assert steps.rules_for(mesh) is MULTIPOD_RULES
        with pytest.raises(RuntimeError, match="already"):
            with fake_world(4):
                pass
    assert not dist.is_initialized()


def test_rules_for_overrides_and_meshless_steps_unchanged():
    dims, names = production_shape()
    with fake_world(256):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
        assert steps.rules_for(mesh) is DEFAULT_RULES
        knobs = steps.PerfKnobs(rule_overrides={"cache": None})
        rules = steps.rules_for(mesh, knobs)
        assert rules.rules["cache"] is None
        assert rules.rules["embed"] == "data"
    # a step without a mesh lays nothing out
    cfg = util.tiny_config("dense")
    from repro_torch.models import model as tm
    model = tm.init_model(cfg, seed=1, device="cpu")
    logits, _ = steps.prefill_step(model, {"tokens": torch.zeros(
        (2, 4), dtype=torch.int32)}, device="cpu")
    assert type(logits) is torch.Tensor and logits.is_inference()


def test_remat_recomputes_under_the_forward_context(monkeypatch):
    """A remat'd group recomputes under the activation sharding of its
    forward, wherever the backward runs: autograd runs a CUDA backward
    on threads of its own, where the context variable is unset.  Here
    the backward runs after the context has closed, as it would look
    from such a thread; every pin of the recomputation must still see
    the forward's context."""
    from repro_torch.models import blocks
    from repro_torch.models import model as tm
    from repro_torch.sharding import activation_sharding, context

    seen = []

    def pin(x, logical_axes, dim_sizes=None):
        seen.append(context.current())
        return x

    monkeypatch.setattr(blocks, "shard_act", pin)
    model = tm.init_model(util.tiny_config("dense"), seed=1, device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    ctx = ("mesh", DEFAULT_RULES)      # plain tensors: nothing is laid out
    with activation_sharding(*ctx):
        logits = model(tokens, mode="train", remat=True)
    forward = len(seen)
    assert forward > 0
    logits.float().sum().backward()
    assert len(seen) > forward            # the recomputation pinned too
    assert all(c == ctx for c in seen)
