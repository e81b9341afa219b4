"""The port's AdamW (``repro_torch.optim``) against the JAX package's.

The same parameters and gradients, drawn with numpy, go through
``repro.optim.adamw_update`` and the port's for several steps, with the
global-norm clip active (large gradients) and inactive (clip above the
norm), in f32 and bf16.  Tolerance: f32 parameters and both moments to
rtol 1e-5, atol 1e-7 (bias corrections are Python floats in the port,
f32 in JAX); bf16 parameters to one bf16 ulp of their magnitude (an f32
difference in the last bit can round the other way).  The schedules
agree at steps 0..30 to rtol 1e-6, atol 1e-7 (JAX evaluates them in
f32, the port in Python floats).
"""

import numpy as np
import pytest
import torch
from torch import nn

from repro_torch import optim as topt
from repro_torch.optim.adamw import grads_of

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402

SHAPES = {"w": (6, 5), "b": (5,), "table": (7, 6)}


def _draw(seed, scale):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _to_f32(t):
    return np.asarray(t.float().detach().numpy() if isinstance(
        t, torch.Tensor) else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale,clip", [(50.0, 1.0), (0.01, 100.0),
                                             (1.0, 0.0)])
def test_adamw_update_matches_jax(dtype, grad_scale, clip):
    init = _draw(0, 1.0)
    jparams = {n: jnp.asarray(a, dtype) for n, a in init.items()}
    module = nn.ParameterDict({n: nn.Parameter(torch.from_numpy(a).to(
        getattr(torch, dtype))) for n, a in init.items()})
    jst, tst = jopt.adamw_init(jparams), topt.adamw_init(module)
    sched = jopt.exp_decay_schedule(1e-2, 0.9, 3)
    tsched = topt.exp_decay_schedule(1e-2, 0.9, 3)
    for step in range(5):
        g = _draw(10 + step, grad_scale)
        jg = {n: jnp.asarray(a, dtype) for n, a in g.items()}
        tg = {n: torch.from_numpy(a).to(getattr(torch, dtype))
              for n, a in g.items()}
        jparams, jst = jopt.adamw_update(jparams, jg, jst, lr=sched,
                                         weight_decay=1e-2, grad_clip=clip)
        module, tst = topt.adamw_update(module, tg, tst, lr=tsched,
                                        weight_decay=1e-2, grad_clip=clip)
        assert tst.step == int(jst.step) == step + 1
        for n in SHAPES:
            want, got = _to_f32(jparams[n]), _to_f32(module[n])
            assert module[n].dtype == getattr(torch, dtype)
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
            else:
                ulp = np.abs(want) * 2.0 ** -7 + 1e-30
                assert (np.abs(got - want) <= ulp).all(), n
            for jm, tm in ((jst.mu, tst.mu), (jst.nu, tst.nu)):
                assert tm[n].dtype == torch.float32
                np.testing.assert_allclose(tm[n].numpy(), np.asarray(jm[n]),
                                           rtol=1e-4 if dtype == "bfloat16"
                                           else 1e-5, atol=1e-7)


def test_weight_decay_reaches_every_leaf_and_unused_grads_are_zero():
    module = nn.ParameterDict({"w": nn.Parameter(torch.ones(3)),
                               "unused": nn.Parameter(torch.ones(2))})
    (module["w"] * 2).sum().backward()
    grads = grads_of(module)
    assert torch.equal(grads["unused"], torch.zeros(2))
    st = topt.adamw_init(module)
    topt.adamw_update(module, grads, st, lr=0.1, weight_decay=0.5)
    # a zero gradient still decays: 1 - 0.1 * 0.5
    np.testing.assert_allclose(module["unused"].detach().numpy(), 0.95,
                               rtol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("exp_decay_schedule", (1e-3, 0.9, 7)),
    ("cosine_schedule", (1.0, 20, 0.1)),
    ("warmup_cosine_schedule", (1.0, 5, 25, 0.0)),
])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in range(0, 31):
        np.testing.assert_allclose(tf(step), float(jf(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-7)
    # continuous, not a staircase
    s = topt.exp_decay_schedule(1.0, 0.5, 10)
    assert s(5) == pytest.approx(0.5 ** 0.5)
