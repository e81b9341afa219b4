"""Parity of the port's layer primitives (``repro_torch.models.layers``)
with the JAX package's (``repro.models.layers``) on the same numpy
inputs.

Tolerance: f32 tensors agree to rtol=1e-5, atol=1e-5 — XLA on the CPU
and PyTorch on the CPU reduce in different orders, nothing more.
"""

import numpy as np
import pytest
import torch

from repro_torch.models import layers as tl

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.models import layers as jl  # noqa: E402


RTOL = ATOL = 1e-5


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _both(tree):
    """The same numpy leaves as a jnp dict and a torch dict."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 40)).astype(np.float32) * 3 + 1
    tree = {"scale": rng.normal(size=40).astype(np.float32)}
    if kind == "layernorm":
        tree["bias"] = rng.normal(size=40).astype(np.float32)
    jp, tp = _both(tree)
    _close(tl.apply_norm(tp, torch.from_numpy(x), 1e-6, kind),
           jl.apply_norm(jp, jnp.asarray(x), 1e-6, kind))


@pytest.mark.parametrize("hd", [32, 40])
def test_rope_split_half(hd):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 128, 3, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128)).copy()
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    d, f = 32, 64
    tree = {"wi": rng.normal(size=(d, f)).astype(np.float32) / 6,
            "wo": rng.normal(size=(f, d)).astype(np.float32) / 8}
    if act == "silu":
        tree["wg"] = rng.normal(size=(d, f)).astype(np.float32) / 6
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    jp, tp = _both(tree)
    _close(tl.apply_mlp(tp, torch.from_numpy(x), act),
           jl.apply_mlp(jp, jnp.asarray(x), act))


def test_embed_unembed_dense():
    rng = np.random.default_rng(3)
    jp, tp = _both({"table": rng.normal(size=(64, 32)).astype(np.float32)})
    ids = rng.integers(0, 64, size=(2, 9)).astype(np.int32)
    _close(tl.apply_embedding(tp, torch.from_numpy(ids)),
           jl.apply_embedding(jp, jnp.asarray(ids)))
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    _close(tl.apply_unembed(tp, torch.from_numpy(x)),
           jl.apply_unembed(jp, jnp.asarray(x)))
    jd, td = _both({"w": rng.normal(size=(32, 16)).astype(np.float32),
                    "b": rng.normal(size=16).astype(np.float32)})
    _close(tl.apply_dense(td, torch.from_numpy(x)),
           jl.apply_dense(jd, jnp.asarray(x)))
