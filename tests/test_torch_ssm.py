"""The port's mLSTM and sLSTM cells (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the same weights (carried by the bridge) and
the same numpy inputs: ``mlstm_full`` (the JAX default, the chunkwise
closed form; the port runs the ``mlstm_scan`` wrapper, whose plain
version runs on the CPU), ``mlstm_step``, ``slstm_full`` and
``slstm_step``, comparing the outputs and every state leaf.

Tolerance: f32 atol=rtol=1e-4 (sums in another order; the mLSTM's h
divides by a running denominator).  bf16 (the config's default type):
the projections round to bf16 at other places in the two frameworks,
so outputs agree to atol=rtol=2e-2 and f32 states to 1e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import ssm as tssm

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import ModelConfig, SSMConfig  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
BF16_STATE = dict(atol=1e-2, rtol=1e-2)


def _cfg(dtype="float32", d=32, heads=2):
    return ModelConfig(name="t", family="ssm", num_layers=2, d_model=d,
                       num_heads=heads, num_kv_heads=heads, d_ff=0,
                       vocab_size=64,
                       ssm=SSMConfig(kind="mlstm", num_heads=heads, expand=2),
                       layer_pattern=("mlstm", "slstm"),
                       moe_pattern=(False, False), dtype=dtype)


def _both(jp):
    """JAX params and the same leaves as torch tensors."""
    return jp, {k: bridge._tensor(np.asarray(v)) for k, v in jp.items()}


def _x(B, T, d, dtype, seed):
    x = np.random.default_rng(seed).normal(size=(B, T, d)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, bridge._tensor(np.asarray(jx))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().detach().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _close_state(port, ref, tol):
    assert set(port) == set(ref)
    for leaf in ref:
        assert port[leaf].dtype == torch.float32, leaf
        _close(port[leaf], ref[leaf], tol)


def _init(kind, cfg, seed):
    init = {"mlstm": jssm.init_mlstm, "slstm": jssm.init_slstm}[kind]
    jp, _ = init(jax.random.PRNGKey(seed), cfg, jnp.dtype(cfg.dtype))
    return _both(jp)


@pytest.mark.parametrize("T", [64, 96])
def test_mlstm_full_and_step(T):
    cfg = _cfg()
    tcfg = bridge.model_config_from(cfg)
    jp, tp = _init("mlstm", cfg, 1)
    jx, tx = _x(2, T, cfg.d_model, jnp.float32, seed=T)
    jy, jst = jssm.mlstm_full(jp, jx, cfg)
    with torch.no_grad():
        ty, tst = tssm.mlstm_full(tp, tx, tcfg)
    _close(ty, jy, F32)
    _close_state(tst, jst, F32)
    jx1, tx1 = _x(2, 1, cfg.d_model, jnp.float32, seed=T + 1)
    jy1, jst1 = jssm.mlstm_step(jp, jx1, jst, cfg)
    with torch.no_grad():
        ty1, tst1 = tssm.mlstm_step(tp, tx1, tst, tcfg)
    _close(ty1, jy1, F32)
    _close_state(tst1, jst1, F32)


@pytest.mark.parametrize("T", [40, 128])
def test_slstm_full_and_step(T):
    cfg = _cfg()
    tcfg = bridge.model_config_from(cfg)
    jp, tp = _init("slstm", cfg, 2)
    jx, tx = _x(2, T, cfg.d_model, jnp.float32, seed=T)
    jy, jst = jssm.slstm_full(jp, jx, cfg)
    with torch.no_grad():
        ty, tst = tssm.slstm_full(tp, tx, tcfg)
    _close(ty, jy, F32)
    _close_state(tst, jst, F32)
    jx1, tx1 = _x(2, 1, cfg.d_model, jnp.float32, seed=T + 1)
    jy1, jst1 = jssm.slstm_step(jp, jx1, jst, cfg)
    with torch.no_grad():
        ty1, tst1 = tssm.slstm_step(tp, tx1, tst, tcfg)
    _close(ty1, jy1, F32)
    _close_state(tst1, jst1, F32)


def test_initial_states_match():
    cfg = _cfg()
    tcfg = bridge.model_config_from(cfg)
    for jst, tst in ((jssm.init_mlstm_state(3, cfg),
                      tssm.init_mlstm_state(3, tcfg)),
                     (jssm.init_slstm_state(3, cfg),
                      tssm.init_slstm_state(3, tcfg))):
        for leaf in jst:
            np.testing.assert_array_equal(tst[leaf].numpy(),
                                          np.asarray(jst[leaf]))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_bf16_full_and_step(kind):
    cfg = _cfg("bfloat16")
    tcfg = bridge.model_config_from(cfg)
    jp, tp = _init(kind, cfg, 3)
    full = {"mlstm": (jssm.mlstm_full, tssm.mlstm_full),
            "slstm": (jssm.slstm_full, tssm.slstm_full)}[kind]
    step = {"mlstm": (jssm.mlstm_step, tssm.mlstm_step),
            "slstm": (jssm.slstm_step, tssm.slstm_step)}[kind]
    jx, tx = _x(2, 64, cfg.d_model, jnp.bfloat16, seed=5)
    jy, jst = full[0](jp, jx, cfg)
    with torch.no_grad():
        ty, tst = full[1](tp, tx, tcfg)
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, BF16)
    _close_state(tst, jst, BF16_STATE)
    jx1, tx1 = _x(2, 1, cfg.d_model, jnp.bfloat16, seed=6)
    jy1, _ = step[0](jp, jx1, jst, cfg)
    with torch.no_grad():
        ty1, _ = step[1](tp, tx1, tst, tcfg)
    _close(ty1, jy1, BF16)
