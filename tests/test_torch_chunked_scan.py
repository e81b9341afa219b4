"""The chunked, checkpointed scan (``repro_torch.models.scan_utils.
chunked_scan``) against the reference's (``repro.models.scan_utils``),
and the sLSTM that runs through it (``repro_torch.models.ssm``).

* ``chunked_scan`` and the reference's give identical outputs, final
  state and gradients on the same numpy inputs (a recurrence exact in
  f32), at one chunk, several and one step a chunk;
* ``slstm_full`` runs ``chunked_scan`` at ``pick_chunk(T, 128)``; its
  forward is bit for bit the straightforward loop over time (the
  recurrent product written as the reference's einsum every step), and
  its gradients are within 1e-5 of each leaf's largest of ``jax.grad``
  of the reference's ``slstm_full``;
* memory under grad at T 1,024: the forward and backward together hold
  no more than the sequence-long tensors (the input, its projection,
  the outputs and their gradients), the chunk-boundary states and one
  chunk's residuals (what autograd saves over one chunk's loop); the
  straightforward loop saves far more, a copy of ``r_h`` each step,
  where no step of the port saves its own (the one laid out before the
  loop is shared).
"""

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.launch import op_costs
from repro_torch.models import ssm as tssm
from repro_torch.models.scan_utils import chunked_scan, pick_chunk
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import ModelConfig, SSMConfig  # noqa: E402
from repro.models.scan_utils import chunked_scan as jchunked_scan  # noqa: E402

GRAD_REL = 1e-5


def _close_rel(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


# ------------------------------------------------------ chunked_scan

def _running_sum(xp):
    """step_chunk over (B, L, d): the state is a running sum and the
    chunk's outputs the sums after each step (small integers: exact in
    f32 in any order)."""
    def step(st, xc):
        ys = st["s"][:, None] + xp.cumsum(xc, axis=1)
        return {"s": ys[:, -1]}, ys * 2.0
    return step


def _torch_step(st, xc):
    ys = st["s"][:, None] + xc.cumsum(dim=1)
    return {"s": ys[:, -1]}, ys * 2.0


@pytest.mark.parametrize("chunk", [12, 4, 1])
def test_chunked_scan_matches_the_reference(chunk):
    rng = np.random.default_rng(chunk)
    x = rng.integers(-4, 5, (2, 12, 3)).astype(np.float32)
    s0 = rng.integers(-4, 5, (2, 3)).astype(np.float32)

    def jloss(s, xs):
        st, ys = jchunked_scan(_running_sum(jnp), {"s": s}, xs, 1, chunk)
        return (ys * ys).sum() + (st["s"] ** 3).sum(), (st, ys)

    (_, (jst, jys)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(s0), jnp.asarray(x))
    ts = torch.from_numpy(s0).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    st, ys = chunked_scan(_torch_step, {"s": ts}, tx, 1, chunk)
    np.testing.assert_array_equal(ys.detach().numpy(), np.asarray(jys))
    np.testing.assert_array_equal(st["s"].detach().numpy(),
                                  np.asarray(jst["s"]))
    ((ys * ys).sum() + (st["s"] ** 3).sum()).backward()
    np.testing.assert_array_equal(ts.grad.numpy(), np.asarray(jgrads[0]))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrads[1]))
    # without grad: a plain loop, the same values
    with torch.no_grad():
        st2, ys2 = chunked_scan(_torch_step, {"s": ts}, tx, 1, chunk)
    assert torch.equal(ys2, ys.detach()) and torch.equal(st2["s"],
                                                         st["s"].detach())
    with pytest.raises(ValueError, match="divide"):
        chunked_scan(_torch_step, {"s": ts}, tx, 1, 5)


# ------------------------------------------------------------ sLSTM

def _cfg(d=64, heads=2):
    return ModelConfig(name="t", family="ssm", num_layers=1, d_model=d,
                       num_heads=heads, num_kv_heads=heads, d_ff=0,
                       vocab_size=64,
                       ssm=SSMConfig(kind="mlstm", num_heads=heads, expand=2),
                       layer_pattern=("slstm",), moe_pattern=(False,),
                       dtype="float32")


def _params(cfg, seed=0):
    jp, _ = jssm.init_slstm(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = tssm._params(**{k: bridge._tensor(np.asarray(v))
                         for k, v in jp.items()})
    return jp, tp


def _per_step_loop(p, x, cfg):
    """``slstm_full`` with the sLSTM as ``ssm._slstm_per_step``: one
    loop over time, the recurrent product as the reference writes it (an
    einsum that lays ``r_h`` out every step).  (y, state)."""
    hs, st = tssm._slstm_per_step(p["r_h"], p["b"], x @ p["w_x"],
                                  tssm.init_slstm_state(x.shape[0], cfg),
                                  cfg)
    return hs.to(x.dtype) @ p["out_proj"], st


@pytest.mark.parametrize("T", [1, 40, 384])
def test_slstm_forward_is_the_per_step_loop_bit_for_bit(T):
    cfg = bridge.model_config_from(_cfg())
    _, tp = _params(_cfg())
    x = torch.from_numpy(np.random.default_rng(T).normal(
        size=(2, T, cfg.d_model)).astype(np.float32))
    assert pick_chunk(T, 128) == min(T, 128)
    with torch.no_grad():
        y, st = tssm.slstm_full(tp, x, cfg)
        y0, st0 = _per_step_loop(tp, x, cfg)
    assert torch.equal(y, y0)
    assert all(torch.equal(st[k], st0[k]) for k in st0)
    # under grad (each chunk in a checkpoint) the same bits
    y1, _ = tssm.slstm_full(tp, x, cfg)
    assert torch.equal(y1.detach(), y0)


@pytest.mark.parametrize("T,chunk", [(64, 128), (96, 16)])
def test_slstm_gradients_match_the_reference(T, chunk):
    jcfg = _cfg()
    cfg = bridge.model_config_from(jcfg)
    jp, tp = _params(jcfg, seed=T)
    x = np.random.default_rng(T).normal(
        size=(2, T, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, st = jssm.slstm_full(p, x, jcfg, chunk=chunk)
        return (y * y).mean() + (st["c"] * st["h"]).sum()

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, st = tssm.slstm_full(tp, tx, cfg, chunk=chunk)
    ((y * y).mean() + (st["c"] * st["h"]).sum()).backward()
    _close_rel(tx.grad, jgx, GRAD_REL)
    for k, v in tp.items():
        _close_rel(v.grad, jg[k], GRAD_REL)


def _saved_storages(fn):
    """{storage key: bytes} of every tensor autograd saves in fn()."""
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st._cdata] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return saved, out


def test_slstm_memory_at_T_1024_is_boundaries_and_one_chunk():
    cfg = bridge.model_config_from(_cfg())
    _, tp = _params(_cfg())
    B, T, d = 2, 1024, cfg.d_model
    ck = pick_chunk(T, 128)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, T, d)).astype(np.float32)).requires_grad_()
    # one chunk's residuals: what autograd saves over one chunk's loop,
    # run without a checkpoint; r_h laid out once, shared by every step
    R = tssm._recurrent(tp["r_h"], cfg)
    wx = (x.detach()[:, :ck] @ tp["w_x"]).requires_grad_()
    saved, _ = _saved_storages(lambda: tssm._slstm_cell_seq(
        R, tp["b"], wx, tssm.init_slstm_state(B, cfg), cfg))
    residual = sum(saved.values())
    assert [n for n in saved.values() if n == tp["r_h"].nbytes] == [R.nbytes]
    assert R.untyped_storage()._cdata in saved

    def peak(fn):
        with op_costs.OpCounter() as c:
            y, st = fn(tp, x, cfg)
            y.sum().backward()
            del y, st
        x.grad = None
        for v in tp.values():
            v.grad = None
        return c.peak_bytes

    # the sequence-long tensors, f32: x, its projection (4d) and the
    # outputs hs and y, and the gradients of x, the projection and hs
    seq_long = B * T * 4 * (d + 4 * d + d + d + d + 4 * d + d)
    boundaries = T // ck * 4 * B * d * 4
    bound = seq_long + boundaries + residual
    assert peak(tssm.slstm_full) <= bound
    # the straightforward loop saves every step's residuals and r_h copy
    saved, _ = _saved_storages(lambda: _per_step_loop(tp, x, cfg))
    assert sum(saved.values()) > bound + (T // ck - 1) * residual
    # (the first step's h, the initial state, takes no gradient)
    assert sum(n == tp["r_h"].nbytes for n in saved.values()) == T - 1
