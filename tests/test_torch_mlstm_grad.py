"""The gradient of the port's mLSTM scan against the JAX package's.

``mlstm_chunkwise_grad_plain`` (torch autograd of the chunkwise plain
version, which the backward kernel ``csrc/mlstm_scan_bwd.cu`` is held
against on the card) against ``jax.grad`` of the reference's
``repro.models.ssm._mlstm_cell_chunkwise`` (the function the JAX
package trains through), for the gradients of q, k, v and both gate
pre-activations given an output gradient: several sequence and chunk
lengths, a zero and a non-zero initial state, and gates that make each
branch of ``max(|den|, exp(-m_t))`` bind (the denominator on most steps,
the stabiliser's floor on most steps, and a mixture).  Then the
wrapper: ``mlstm_chunkwise`` is differentiable on the CPU through the
same ``autograd.Function`` the card uses, refuses an initial state that
requires grad before anything runs, and raises when a non-zero
gradient reaches the final state.

Tolerance: each gradient within 1e-5 of its largest magnitude (f32
sums in other orders).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.mlstm_scan import ops as ml
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import _mlstm_cell_chunkwise  # noqa: E402

REL = 1e-5
# (B, S, H, dh, chunk, carried state, gates)
CASES = [
    (2, 16, 2, 8, 64, False, "den"),
    (2, 48, 2, 16, 16, False, "den"),
    (1, 40, 3, 8, 8, True, "den"),
    (2, 36, 2, 8, 12, True, "mixed"),
    (2, 32, 2, 16, 8, False, "floor"),
    (1, 30, 2, 8, 64, True, "floor"),
]


def _inputs(B, S, H, dh, carried, gates, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, dh_ = r(B, S, H, dh), r(B, S, H, dh), r(B, S, H, dh), \
        r(B, S, H, dh)
    if gates == "den":       # the model's forget bias: |den| binds
        i, f = r(B, S, H), r(B, S, H) + 3.0
    elif gates == "floor":   # shut input gates: exp(-m_t) binds
        i, f = r(B, S, H) - 8.0, r(B, S, H) - 1.0
    else:
        i, f = 3.0 * r(B, S, H), 3.0 * r(B, S, H)
    if carried:
        state = {"C": 0.3 * r(B, H, dh, dh), "n": 0.3 * r(B, H, dh),
                 "m": r(B, H)}
    else:
        state = {"C": np.zeros((B, H, dh, dh), np.float32),
                 "n": np.zeros((B, H, dh), np.float32),
                 "m": np.zeros((B, H), np.float32)}
    return (q, k, v, i, f), state, dh_


def _floor_share(x, state):
    """The share of (step, row) where exp(-m_t) binds, from the
    sequential recurrence."""
    q, k, v, i, f = (torch.from_numpy(a) for a in x)
    C, n, m = (torch.from_numpy(state[s]) for s in "Cnm")
    scale, hits = 1 / math.sqrt(q.shape[-1]), []
    for t in range(q.shape[1]):
        logf = ml.log_sigmoid(f[:, t])
        m_new = torch.maximum(logf + m, i[:, t])
        fa = torch.exp(logf + m - m_new)
        ia = torch.exp(i[:, t] - m_new)
        n = fa[..., None] * n + ia[..., None] * k[:, t]
        den = (n * q[:, t] * scale).sum(-1).abs()
        hits.append(den < torch.exp(-m_new))
        m = m_new
    return float(torch.stack(hits).float().mean())


@pytest.mark.parametrize("case", CASES)
def test_plain_grad_matches_jax_chunkwise(case):
    B, S, H, dh, chunk, carried, gates = case
    x, state, dh_ = _inputs(B, S, H, dh, carried, gates)
    share = _floor_share(x, state)
    if gates == "den":
        assert share < 0.5, share
    elif gates == "floor":
        assert share > 0.8, share
    else:
        assert 0.05 < share < 0.95, share

    def jloss(*xs):
        h, _ = _mlstm_cell_chunkwise(*xs, {s: jnp.asarray(a)
                                           for s, a in state.items()},
                                     chunk=chunk)
        return jnp.sum(h * dh_)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*x)
    got = ml.mlstm_chunkwise_grad_plain(
        *(torch.from_numpy(a) for a in x),
        {s: torch.from_numpy(a) for s, a in state.items()},
        torch.from_numpy(dh_), chunk=chunk)
    for name, g, w in zip(("q", "k", "v", "i", "f"), got, want):
        w = np.asarray(w, np.float64)
        scale = max(np.abs(w).max(), 1e-12)
        err = np.abs(g.numpy() - w).max()
        assert err <= REL * scale, (name, err, scale)


def _leaves(seed=1):
    x, state, dh_ = _inputs(2, 24, 2, 8, False, "den", seed)
    xs = [torch.from_numpy(a).requires_grad_(True) for a in x]
    return xs, {s: torch.from_numpy(a) for s, a in state.items()}, \
        torch.from_numpy(dh_)


def test_wrapper_is_differentiable_on_the_cpu():
    xs, state, dh_ = _leaves()
    h, _ = ml.mlstm_chunkwise(*xs, state)
    assert h.grad_fn is not None
    h.backward(dh_)
    want = ml.mlstm_chunkwise_grad_plain(*xs, state, dh_)
    for x, w in zip(xs, want):
        assert torch.equal(x.grad, w)


def test_wrapper_refuses_a_gradient_into_or_out_of_the_state():
    xs, state, dh_ = _leaves()
    state["C"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="initial state requires grad"):
        ml.mlstm_chunkwise(*xs, state)
    state["C"].requires_grad_(False)
    for name in ("C", "n", "m"):
        h, out = ml.mlstm_chunkwise(*xs, state)
        with pytest.raises(RuntimeError, match="final state"):
            ((h * dh_).sum() + out[name].sum()).backward()
    # a zero gradient at the final state is no gradient
    h, out = ml.mlstm_chunkwise(*xs, state)
    ((h * dh_).sum() + 0.0 * out["C"].sum()).backward()
    with torch.no_grad():   # no grad wanted: the plain version, no checks
        h2, _ = ml.mlstm_chunkwise(*(x.detach() for x in xs), state)
    assert torch.equal(h2, h.detach())
