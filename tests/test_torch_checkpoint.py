"""The port's checkpoints (``repro_torch.checkpoint``, the bridge's
``model_tree`` / ``router_tree`` and ``*_from_checkpoint``) against the
JAX package's ``repro.checkpoint``.

For reduced zoo configs in bf16 (tinyllama; gemma3 at 8 layers, one
6-layer unit and 2 remainder layers; qwen2-moe) and a router with an
uncertainty head: a checkpoint the JAX package saves loads in the port
and one the port saves loads in the JAX package, every leaf bit-equal
(bf16 as its bits) and the ``.json`` sidecars byte-identical;
``model_from_checkpoint`` gives the same logits as ``model_from_jax``
(exactly: the same weights through the same code), and the JAX model
gives the same logits from the port's file as from its own params.
``CheckpointManager`` keeps the best and the last k as the reference's
``tests/test_checkpoint.py`` pins it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    save_pytree)
from repro_torch.core import router as trouter
from repro_torch.models import model as tm
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.router import RouterConfig, init_router  # noqa: E402
from repro.models import model as jm  # noqa: E402

CONFIGS = {"tinyllama-1.1b": {}, "gemma3-4b": {"num_layers": 8},
           "qwen2-moe-a2.7b": {}}


def _jcfg(arch):
    cfg = jget_config(arch).reduced(d_model=64)
    return dataclasses.replace(cfg, dtype="bfloat16", **CONFIGS[arch])


def _bits(x):
    """A leaf (tensor or array) as numpy, bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for name in la:
        x, y = _bits(la[name]), _bits(lb[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _tokens(cfg):
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)


@pytest.fixture(scope="module", params=list(CONFIGS))
def saved(request, tmp_path_factory):
    """A JAX model's params saved by the JAX package, and the port's
    save of the same model: (cfg, params, jax path, port path)."""
    jcfg = _jcfg(request.param)
    params, _ = jm.init_model(jax.random.PRNGKey(5), jcfg)
    d = tmp_path_factory.mktemp(request.param)
    jpath, tpath = str(d / "jax" / "model"), str(d / "port" / "model")
    jck.save_pytree(jpath, params)
    model = bridge.model_from_jax(params, bridge.model_config_from(jcfg),
                                  device="cpu")
    save_pytree(tpath, bridge.model_tree(model))
    return jcfg, params, jpath, tpath


def test_jax_checkpoint_loads_in_the_port(saved):
    jcfg, params, jpath, _ = saved
    _same_tree(load_pytree(jpath), params)
    cfg = bridge.model_config_from(jcfg)
    a = bridge.model_from_checkpoint(jpath, cfg, device="cpu")
    b = bridge.model_from_jax(params, cfg, device="cpu")
    for (n, x), (m, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert n == m and x.dtype == y.dtype and torch.equal(x, y)
    toks = torch.from_numpy(_tokens(jcfg))
    with torch.inference_mode():
        la, _ = tm.prefill(a, {"tokens": toks})
        lb, _ = tm.prefill(b, {"tokens": toks})
    assert torch.equal(la, lb)


def test_port_checkpoint_loads_in_jax(saved):
    jcfg, params, jpath, tpath = saved
    for ext in (".json",):
        with open(jpath + ext, "rb") as f, open(tpath + ext, "rb") as g:
            assert f.read() == g.read()
    with np.load(jpath + ".npz") as zj, np.load(tpath + ".npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype
            np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    back = jck.load_pytree(tpath)
    _same_tree(back, params)
    toks = jnp.asarray(_tokens(jcfg))
    want, _ = jm.prefill(params, jcfg, {"tokens": toks})
    got, _ = jm.prefill(jax.tree.map(jnp.asarray, back), jcfg,
                        {"tokens": toks})
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))


def test_router_checkpoint_round_trips_both_ways(tmp_path):
    rc = RouterConfig(n_models=3, vocab_size=64, num_layers=2, d_model=32,
                      num_heads=2, d_ff=64)
    rp, _ = init_router(jax.random.PRNGKey(3), rc, uncertainty=True)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save_pytree(jpath, rp)
    port_rc = trouter.RouterConfig(**vars(rc))
    router = bridge.router_from_checkpoint(jpath, port_rc, device="cpu")
    assert router.unc is not None
    save_pytree(tpath, bridge.router_tree(router))
    with open(jpath + ".json", "rb") as f, open(tpath + ".json", "rb") as g:
        assert f.read() == g.read()
    _same_tree(jck.load_pytree(tpath), rp)
    ref = bridge.router_from_jax(rp, port_rc, device="cpu")
    toks = torch.from_numpy(_tokens(rc))
    with torch.inference_mode():
        assert torch.equal(trouter.predict_losses(router, port_rc,
                                                  {"tokens": toks}),
                           trouter.predict_losses(ref, port_rc,
                                                  {"tokens": toks}))


def test_roundtrip_keeps_structure_and_dtypes(tmp_path):
    """The reference's round-trip case (tests/test_checkpoint.py) and its
    file read by the JAX package: tuples, ints, bf16."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16) * 1.5,
                       "c": (torch.zeros(2), torch.tensor(3)),
                       "d": [np.arange(3, dtype=np.int32)]}}
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree)
    back = load_pytree(path)
    assert isinstance(back["nested"]["c"], tuple)
    assert isinstance(back["nested"]["d"], list)
    assert back["nested"]["b"].dtype == torch.bfloat16
    assert back["nested"]["c"][1].dtype == torch.int64
    assert back["nested"]["d"][0].dtype == torch.int32
    _same_tree(back, tree)
    jback = jck.load_pytree(path)
    assert jback["nested"]["b"].dtype == ml_dtypes.bfloat16
    assert isinstance(jback["nested"]["c"], tuple)
    _same_tree(jback, tree)


def test_manager_best_and_retention(tmp_path):
    """As tests/test_checkpoint.py pins the reference's manager."""
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for step, metric in [(1, 0.5), (2, 0.3), (3, 0.4), (4, 0.35)]:
        mgr.save(step, {"w": torch.tensor(float(step))}, metric=metric)
    assert float(mgr.load_best()["w"]) == 2.0     # step 2 had the lowest
    files = {f for f in os.listdir(tmp_path) if f.startswith("step_")}
    assert files == {f"step_{s:08d}{e}" for s in (3, 4)
                     for e in (".npz", ".json")}
    assert float(mgr.load_step(4)["w"]) == 4.0
    assert mgr.best_metric == 0.3
    jmgr = jck.CheckpointManager(str(tmp_path / "jax"), keep_last=2)
    for step, metric in [(1, 0.5), (2, 0.3), (3, 0.4), (4, 0.35)]:
        jmgr.save(step, {"w": jnp.array(float(step))}, metric=metric)
    assert {f for f in os.listdir(tmp_path / "jax")} == files | {
        "best.npz", "best.json"}
