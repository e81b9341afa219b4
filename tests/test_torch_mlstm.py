"""The mLSTM scan's plain versions (``repro_torch.kernels.mlstm_scan.ops``)
against the JAX package's oracles on the same numpy inputs:
``repro.kernels.mlstm_scan.ref.mlstm_ref`` (sequential, (BH, S, dh)
layout), ``repro.models.ssm._mlstm_cell_chunkwise`` and
``_mlstm_cell_seq``.  The Pallas kernel itself does not run in
interpret mode under jax 0.9.0, so these are the references; on the CPU
the port's wrapper ``mlstm_chunkwise`` runs ``mlstm_chunkwise_plain``
at the kernel's chunk length, and the JAX cases' other chunk lengths go
to ``mlstm_chunkwise_plain`` directly.

Tolerance: atol=5e-4, rtol=1e-3, as ``tests/test_kernels.py`` holds the
Pallas kernel to ``mlstm_ref`` (chunkwise and sequential forms sum in
different orders, and h divides by a running denominator).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import launches
from repro_torch.kernels.mlstm_scan import ops

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.mlstm_scan.ref import mlstm_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

TOL = dict(atol=5e-4, rtol=1e-3)


def _inputs(B, S, H, dh, seed, carried=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = {"q": f(B, S, H, dh), "k": f(B, S, H, dh), "v": f(B, S, H, dh),
         "i": f(B, S, H), "f": f(B, S, H) + 3.0}
    if carried:
        st = {"C": f(B, H, dh, dh) * 0.3, "n": f(B, H, dh) * 0.3,
              "m": f(B, H)}
    else:
        st = {"C": np.zeros((B, H, dh, dh), np.float32),
              "n": np.zeros((B, H, dh), np.float32),
              "m": np.zeros((B, H), np.float32)}
    return x, st


def _torch(x, st):
    t = lambda a: torch.from_numpy(a)
    return ([t(x[k]) for k in "qkvif"], {k: t(v) for k, v in st.items()})


def _jax(x, st):
    return ([jnp.asarray(x[k]) for k in "qkvif"],
            {k: jnp.asarray(v) for k, v in st.items()})


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def _close_state(port, ref):
    for leaf in ("C", "n", "m"):
        _close(port[leaf], ref[leaf])


CASES = [  # (B, S, H, dh, chunk): tests/test_kernels.py's mlstm cases
    (1, 64, 1, 16, 16),
    (2, 128, 2, 32, 32),
    (1, 128, 2, 64, 64),
    (2, 96, 1, 32, 32),   # 3 chunks
]


@pytest.mark.parametrize("B,S,H,dh,chunk", CASES)
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_chunkwise_plain_vs_mlstm_ref(B, S, H, dh, chunk, carried):
    x, st = _inputs(B, S, H, dh, seed=S + dh, carried=carried)
    args, tst = _torch(x, st)
    h, new = ops.mlstm_chunkwise_plain(*args, tst, chunk=chunk)
    tb = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, S, dh)
    tb2 = lambda a: a.transpose(0, 2, 1).reshape(B * H, S)
    hr, Cr, nr, mr = mlstm_ref(
        *(jnp.asarray(tb(x[k])) for k in "qkv"),
        *(jnp.asarray(tb2(x[k])) for k in "if"),
        jnp.asarray(st["C"].reshape(B * H, dh, dh)),
        jnp.asarray(st["n"].reshape(B * H, dh)),
        jnp.asarray(st["m"].reshape(B * H)))
    _close(h, np.asarray(hr).reshape(B, H, S, dh).transpose(0, 2, 1, 3))
    _close(new["C"], np.asarray(Cr).reshape(B, H, dh, dh))
    _close(new["n"], np.asarray(nr).reshape(B, H, dh))
    _close(new["m"], np.asarray(mr).reshape(B, H))


@pytest.mark.parametrize("B,S,H,dh,chunk", CASES)
def test_chunkwise_plain_vs_jax_chunkwise(B, S, H, dh, chunk):
    x, st = _inputs(B, S, H, dh, seed=7 * S + dh, carried=True)
    args, tst = _torch(x, st)
    h, new = ops.mlstm_chunkwise_plain(*args, tst, chunk=chunk)
    jargs, jst = _jax(x, st)
    hr, ref = jssm._mlstm_cell_chunkwise(*jargs, jst, chunk=chunk)
    _close(h, hr)
    _close_state(new, ref)


def test_two_halves_with_carried_state_equal_one_run():
    x, st = _inputs(1, 96, 2, 16, seed=4)
    args, tst = _torch(x, st)
    h_full, st_full = ops.mlstm_chunkwise(*args, tst)
    h1, st1 = ops.mlstm_chunkwise(*(a[:, :48] for a in args), tst)
    h2, st2 = ops.mlstm_chunkwise(*(a[:, 48:] for a in args), st1)
    _close(torch.cat([h1, h2], dim=1), h_full)
    _close_state(st2, st_full)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_sequential_vs_jax_cell_seq(carried):
    x, st = _inputs(2, 40, 2, 16, seed=11, carried=carried)
    args, tst = _torch(x, st)
    h, new = ops.mlstm_sequential(*args, tst)
    jargs, jst = _jax(x, st)
    hr, ref = jssm._mlstm_cell_seq(*jargs, jst)
    _close(h, hr)
    _close_state(new, ref)


@pytest.mark.parametrize("S", [96, 97])   # 97 is prime: chunks of 1
def test_chunkwise_plain_matches_sequential(S):
    x, st = _inputs(2, S, 2, 32, seed=S, carried=True)
    args, tst = _torch(x, st)
    launches.reset_launch_counts()
    h, new = ops.mlstm_chunkwise(*args, tst)
    assert launches.launch_counts()["mlstm_scan"] == 0   # CPU: plain path
    hs, seq = ops.mlstm_sequential(*args, tst)
    _close(h, hs)
    _close_state(new, seq)


def test_wrapper_rejects_bad_inputs():
    x, st = _inputs(1, 8, 1, 16, seed=0)
    args, tst = _torch(x, st)
    with pytest.raises(TypeError, match="float32"):
        ops.mlstm_chunkwise(*(a.double() for a in args), tst)
    with pytest.raises(ValueError, match="C"):
        ops.mlstm_chunkwise(*args, dict(tst, C=tst["C"][..., :8]))
    with pytest.raises(ValueError, match="empty"):
        ops.mlstm_chunkwise(*(a[:, :0] for a in args), tst)
