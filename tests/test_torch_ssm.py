"""The port's recurrent cells (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the same weights (carried by the bridge) and
the same numpy inputs: ``mlstm_full`` (the JAX default, the chunkwise
closed form; the port runs the ``mlstm_scan`` wrapper, whose plain
version runs on the CPU), ``mlstm_step``, ``slstm_full`` and
``slstm_step``, comparing the outputs and every state leaf.  Mamba:
``mamba_full`` (one chunk and two) and ``mamba_step`` against the
reference's, output and state; ``mamba_step`` token by token against
``mamba_full``; ``mamba_full`` at chunk 4 against chunk 256; and
``init_mamba``'s deterministic leaves (``A_log`` to one f32 ulp: the
libraries' logs differ in the last bit) and the range of its ``dt_b``
against the reference's.  Mamba is held to rtol=atol=1e-5 (f32; its
scan combines in another tree order).

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
MAMBA = dict(atol=1e-5, rtol=1e-5)


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


# =================================================================== mamba

def _mamba_cfg(d=32):
    return ModelConfig(name="m", family="hybrid", num_layers=1, d_model=d,
                       num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=64,
                       ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4,
                                     expand=2),
                       layer_pattern=("mamba",), moe_pattern=(False,),
                       dtype="float32")


@pytest.fixture(scope="module")
def mamba():
    """(JAX config, port config, JAX params, torch params)."""
    cfg = _mamba_cfg()
    jp, _ = jssm.init_mamba(jax.random.PRNGKey(4), cfg, jnp.float32)
    # a non-zero conv bias, so the convolution's bias path is held too
    jp = dict(jp, conv_b=jnp.linspace(-0.5, 0.5, jp["conv_b"].shape[0]))
    return (cfg, bridge.model_config_from(cfg)) + _both(jp)


@pytest.mark.parametrize("T", [40, 300])     # one chunk; two of 150
def test_mamba_full_and_step_match(mamba, T):
    cfg, tcfg, jp, tp = mamba
    jx, tx = _x(2, T, cfg.d_model, jnp.float32, seed=T)
    jy, jst = jssm.mamba_full(jp, jx, cfg)
    with torch.no_grad():
        ty, tst = tssm.mamba_full(tp, tx, tcfg)
    _close(ty, jy, MAMBA)
    assert set(tst) == set(jst) == {"h", "conv"}
    for leaf in jst:
        _close(tst[leaf], jst[leaf], MAMBA)
    jx1, tx1 = _x(2, 1, cfg.d_model, jnp.float32, seed=T + 1)
    jy1, jst1 = jssm.mamba_step(jp, jx1, jst, cfg)
    with torch.no_grad():
        ty1, tst1 = tssm.mamba_step(tp, tx1, tst, tcfg)
    _close(ty1, jy1, MAMBA)
    for leaf in jst1:
        _close(tst1[leaf], jst1[leaf], MAMBA)


def test_mamba_step_by_step_equals_full_and_chunks_do_not_matter(mamba):
    _, tcfg, _, tp = mamba
    _, tx = _x(2, 24, tcfg.d_model, jnp.float32, seed=9)
    with torch.no_grad():
        y, st = tssm.mamba_full(tp, tx, tcfg)
        y4, st4 = tssm.mamba_full(tp, tx, tcfg, chunk=4)
        state = tssm.init_mamba_state(2, tcfg)
        steps = []
        for t in range(tx.shape[1]):
            y1, state = tssm.mamba_step(tp, tx[:, t:t + 1], state, tcfg)
            steps.append(y1)
    for got, got_st in ((torch.cat(steps, 1), state), (y4, st4)):
        _close(got, y, MAMBA)
        for leaf in st:
            _close(got_st[leaf], st[leaf], MAMBA)


def test_init_mamba_matches_the_reference():
    cfg = _mamba_cfg()
    tcfg = bridge.model_config_from(cfg)
    jp, _ = jssm.init_mamba(jax.random.PRNGKey(5), cfg, jnp.float32)
    tp = tssm.init_mamba(torch.Generator().manual_seed(5), tcfg)
    assert set(tp) == set(jp)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape, name
        assert str(tp[name].dtype).removeprefix("torch.") == str(
            jp[name].dtype), name
    for name in ("D", "conv_b"):
        np.testing.assert_array_equal(tp[name].detach().numpy(),
                                      np.asarray(jp[name]))
    # log(1..16): the two libraries' f32 log differ in the last bit of one
    np.testing.assert_array_max_ulp(tp["A_log"].detach().numpy(),
                                    np.asarray(jp["A_log"]), maxulp=1)
    # dt_b is softplus^-1 of a step drawn log-uniform in [1e-3, 1e-1]
    for dt_b in (tp["dt_b"].detach(), torch.tensor(np.asarray(
            jp["dt_b"]))):
        step = torch.nn.functional.softplus(dt_b)
        assert bool(((step >= 1e-3 * (1 - 1e-5))
                     & (step <= 1e-1 * (1 + 1e-5))).all())
        assert float(step.log().std()) > 0.5      # spread, not constant
    jst = jssm.init_mamba_state(3, cfg, jnp.bfloat16)
    tst = tssm.init_mamba_state(3, tcfg, torch.bfloat16)
    for leaf in jst:
        assert tuple(tst[leaf].shape) == jst[leaf].shape
        assert str(tst[leaf].dtype).removeprefix("torch.") == str(
            jst[leaf].dtype)
        assert not tst[leaf].any()
