"""The port's fused routing heads against the JAX package's Pallas
kernels.

On the CPU the port's ``router_route`` / ``router_route_cascade`` run
their plain versions; they are held against ``router_score_fused`` and
``router_score_cascade_fused`` in interpret mode and against their
``ref.py`` oracles: batches of 1, 3 and 37 rows at a small width, of
8 and 32 rows at the main path's (d = hh = 128, 11 experts, 2
constraints) and with 33 experts, rows built to tie on the constrained
score (the first index wins), a tie on the escalation
ladder (the earliest rung wins), a pick on the top rung (``esc ==
choice``), and pad-row independence.  The CUDA kernels are held
against the plain versions on the card in ``tests/test_torch_gpu.py``.

Tolerance: f32 outputs agree to rtol=1e-5, atol=1e-5 (different
reduction orders); choices and escalation targets are exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.router_cascade.kernel import router_score_cascade_fused  # noqa: E402
from repro.kernels.router_cascade.ref import router_score_cascade_ref  # noqa: E402
from repro.kernels.router_score.kernel import router_score_fused  # noqa: E402
from repro.kernels.router_score.ref import router_score_ref  # noqa: E402


RTOL = ATOL = 1e-5
D, HH, M, NC = 32, 48, 5, 2
LADDER = np.array([3, 0, 4, 1, 2], np.int32)   # expert -> rung
# (B, d, hh, M, n_c): the small width, the main path's, 33 experts
SHAPES = [(1, D, HH, M, NC), (3, D, HH, M, NC), (37, D, HH, M, NC),
          (8, 128, 128, 11, 2), (32, 128, 128, 11, 2), (5, 128, 128, 33, 2)]


def _case(B, seed=0, d=D, hh=HH, m=M, nc=NC):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"emb": f(B, d), "w1": f(d, hh) / 5, "b1": f(hh) / 5,
            "w2": f(hh, m) / 6, "b2": f(m) / 5, "uw1": f(d, hh) / 5,
            "ub1": f(hh) / 5, "uw2": f(hh, m) / 6, "ub2": f(m) / 5,
            "cvals": np.abs(f(nc, m)), "lam": np.abs(f(B, nc))}


def _ladder(m):
    """The test ladder at 5 experts, else a seeded permutation."""
    return LADDER if m == M else np.random.default_rng(m).permutation(
        m).astype(np.int32)


def _tied(B):
    """Every expert gets the same loss and no constraint: each row ties
    on all M columns of the constrained score."""
    c = _case(B, seed=7)
    c["w2"][:] = c["w2"][:, :1]
    c["b2"][:] = 0.3
    c["uw2"][:] = c["uw2"][:, :1]
    c["lam"][:] = 0.0
    return c


SCORE_KEYS = ("emb", "w1", "b1", "w2", "b2", "cvals", "lam")
CASCADE_KEYS = ("emb", "w1", "b1", "w2", "b2", "uw1", "ub1", "uw2", "ub2",
                "cvals", "lam")


def _port_score(c):
    t = {k: torch.from_numpy(c[k]) for k in SCORE_KEYS}
    head = {k: t[k] for k in ("w1", "b1", "w2", "b2")}
    pred, choice = rs_ops.router_route(t["emb"], head, c["cvals"], c["lam"])
    return pred.numpy(), choice.numpy()


def _port_cascade(c):
    t = {k: torch.from_numpy(c[k]) for k in CASCADE_KEYS}
    head = {k: t[k] for k in ("w1", "b1", "w2", "b2")}
    unc = {k[1:]: t[k] for k in ("uw1", "ub1", "uw2", "ub2")}
    out = rc_ops.router_route_cascade(t["emb"], head, unc, c["cvals"],
                                      c["lam"], _ladder(c["b2"].shape[0]))
    return tuple(o.numpy() for o in out)


def _check_score(c):
    pred, choice = _port_score(c)
    args = [jnp.asarray(c[k]) for k in SCORE_KEYS]
    for jpred, jchoice in (router_score_fused(*args, block_b=8,
                                              interpret=True),
                           router_score_ref(*args)):
        np.testing.assert_allclose(pred, np.asarray(jpred), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(choice, np.asarray(jchoice))
    assert choice.dtype == np.int32
    return choice


def _check_cascade(c):
    pred, sigma, choice, esc = _port_cascade(c)
    args = [jnp.asarray(c[k]) for k in CASCADE_KEYS] + [
        jnp.asarray(_ladder(c["b2"].shape[0]))]
    for ref in (router_score_cascade_fused(*args, block_b=8, interpret=True),
                router_score_cascade_ref(*args)):
        jpred, jsigma, jchoice, jesc = (np.asarray(a) for a in ref)
        np.testing.assert_allclose(pred, jpred, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(sigma, jsigma, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(choice, jchoice)
        np.testing.assert_array_equal(esc, jesc)
    return choice, esc


@pytest.mark.parametrize("B,d,hh,m,nc", SHAPES)
def test_router_route_matches_pallas(B, d, hh, m, nc):
    _check_score(_case(B, B, d, hh, m, nc))


@pytest.mark.parametrize("B,d,hh,m,nc", SHAPES)
def test_router_route_cascade_matches_pallas(B, d, hh, m, nc):
    _check_cascade(_case(B, B + 100, d, hh, m, nc))


def test_ties_go_to_the_first_index():
    choice = _check_score(_tied(4))
    assert (choice == 0).all()
    choice, _ = _check_cascade(_tied(4))
    assert (choice == 0).all()


def test_ladder_tie_goes_to_the_earliest_rung():
    """All experts tie, the pick is expert 0 (rung 3), and the experts
    above it are 2 (rung 4) only — then, with expert 1 picked (rung 0),
    experts 0, 2, 3, 4 tie above it and expert 3 (rung 1) must win over
    the lower index 0."""
    c = _tied(2)
    _, esc = _check_cascade(c)
    assert (esc == 2).all()
    c["b2"][1] = 0.0            # expert 1 scores lowest: rung 0
    choice, esc = _check_cascade(c)
    assert (choice == 1).all() and (esc == 3).all()


def test_top_rung_pick_echoes_choice():
    c = _case(6, seed=3)
    c["b2"][2] = -50.0          # expert 2 (rung 4, the top) always wins
    c["lam"][:] = 0.0
    choice, esc = _check_cascade(c)
    assert (choice == 2).all() and (esc == choice).all()


def test_pad_rows_do_not_change_real_rows():
    c = _case(3, seed=11)
    padded = dict(c)
    rng = np.random.default_rng(12)
    padded["emb"] = np.concatenate(
        [c["emb"], rng.normal(size=(5, D)).astype(np.float32) * 9])
    padded["lam"] = np.concatenate(
        [c["lam"], np.abs(rng.normal(size=(5, NC))).astype(np.float32)])
    for port in (_port_score, _port_cascade):
        alone, more = port(c), port(padded)
        for a, b in zip(alone, more):
            np.testing.assert_allclose(a, b[:3], rtol=RTOL, atol=ATOL)
            if a.dtype == np.int32:
                np.testing.assert_array_equal(a, b[:3])


def test_launch_plan_clamps_the_tile():
    """A cluster of CLUSTER blocks per row, each a slice of the hidden
    units; the k-groups fill at most THREADS threads and never
    outnumber the rows of w1; the block is whole warps."""
    assert (rs_ops.CLUSTER, rs_ops.THREADS) == (8, 256)
    assert rs_ops.decision_plan(37, 128, 128) == {
        "grid": 296, "cluster": 8, "units_per_block": 16, "threads": 256,
        "k_groups": 16}
    assert rc_ops.decision_plan(32, 128, 128) == {
        "grid": 256, "cluster": 8, "units_per_block": 16, "threads": 256,
        "k_groups": 8}
    plan = rs_ops.decision_plan(3, 80, 96)                       # 12 units
    assert (plan["k_groups"], plan["threads"]) == (16, 192)
    plan = rs_ops.decision_plan(1, 2, 48)                        # d = 2
    assert (plan["k_groups"], plan["threads"]) == (2, 32)
    assert rs_ops.decision_plan(1, 1, 20)["threads"] == 32       # whole warps
    plan = rs_ops.decision_plan(1, 128, 4096)                    # > THREADS
    assert (plan["units_per_block"], plan["k_groups"],
            plan["threads"]) == (512, 1, 256)


def test_wrappers_check_their_inputs():
    c = {k: torch.from_numpy(v) for k, v in _case(3).items()}
    with pytest.raises(ValueError, match="lam"):
        rs_ops.router_score_fused(c["emb"], c["w1"], c["b1"], c["w2"],
                                  c["b2"], c["cvals"], c["lam"][:2])
    with pytest.raises(TypeError, match="float32"):
        rs_ops.router_score_fused(c["emb"].double(), c["w1"], c["b1"],
                                  c["w2"], c["b2"], c["cvals"], c["lam"])
