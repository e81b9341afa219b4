"""The port's dense encoder against the JAX package's, through the
weight bridge: ``encode`` hidden states and ``forward(mode="train")``
logits of the ``tiny_library`` experts and of the router encoder, plus
the router's pooled embedding and both heads.

Tolerance: f32 tensors agree to rtol=1e-5, atol=1e-5 (XLA and PyTorch
on the CPU reduce in different orders).
"""

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import router as trouter
from repro_torch.models.model import count_params, encode, forward

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import router as jrouter  # noqa: E402
from repro.models.model import encode as jencode  # noqa: E402
from repro.models.model import forward as jforward  # noqa: E402


RTOL = ATOL = 1e-5
RC = jrouter.RouterConfig(n_models=3, vocab_size=64, num_layers=1,
                          d_model=32, num_heads=2, d_ff=64)


def _tokens(seed=0, B=3, S=32, V=64):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, V, size=(B, S)).astype(np.int32)
    toks[0, -5:] = 0     # pad tokens: attended to, masked only in _pool
    toks[2, :] = 0       # an all-pad row pools to zero
    return toks


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_expert_encode_and_logits(tiny_library, idx):
    e = tiny_library.experts[idx]
    model = bridge.model_from_jax(e.params, bridge.model_config_from(e.cfg),
                                  device="cpu")
    assert count_params(model) == e.n_params
    toks = _tokens(idx)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        _close(encode(model, tb), jencode(e.params, e.cfg, jb))
        logits, _, _ = jforward(e.params, e.cfg, jb, mode="train",
                                remat=False)
        _close(forward(model, tb, mode="train"), logits)


@pytest.mark.parametrize("uncertainty", [False, True])
def test_router_embedding_and_heads(uncertainty):
    jp, _ = jrouter.init_router(jax.random.PRNGKey(9), RC,
                                uncertainty=uncertainty)
    trc = trouter.RouterConfig(**vars(RC))
    router = bridge.router_from_jax(jp, trc, device="cpu")
    assert (router.unc is not None) == uncertainty
    toks = _tokens(5)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        emb = trouter.router_embed(router, trc, tb)
        _close(emb, jrouter.router_embed(jp, RC, jb))
        assert not emb[2].any()
        _close(trouter.predict_losses(router, trc, tb),
               jrouter.predict_losses(jp, RC, jb))
        _close(trouter.predict_uncertainty(router, trc, tb),
               jrouter.predict_uncertainty(jp, RC, jb))


def test_bridge_rejects_a_mismatched_tree(tiny_library):
    e = tiny_library.experts[0]
    other = bridge.model_config_from(tiny_library.experts[1].cfg)
    with pytest.raises(ValueError, match="shape"):
        bridge.model_from_jax(e.params, other, device="cpu")
    tree = {k: v for k, v in e.params.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        bridge.model_from_jax(tree, bridge.model_config_from(e.cfg),
                              device="cpu")


def test_paper_library_sizes_match(tiny_library):
    """The port's paper-scale library has the JAX package's parameter
    counts, so size constraints and the escalation ladder agree."""
    from repro.core.library import paper_library_specs as jspecs
    from repro.models.model import init_model_logical
    from repro_torch.core.library import paper_library_specs as tspecs
    from repro_torch.models.model import init_model
    for je, te in zip(jspecs(512)[:4], tspecs(512)[:4]):
        abstract, _ = init_model_logical(je.cfg)
        n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(abstract))
        assert count_params(init_model(te.cfg, device="cpu")) == n


def test_library_methods_match(tiny_library):
    """``ExpertSpec.describe``, ``ModelLibrary.names`` and
    ``ModelLibrary.set_params`` of the port against the JAX package's,
    on the paper library's specs (with parameter counts set) and on
    ``tiny_library`` through the bridge."""
    from repro.core.library import ModelLibrary as JLibrary
    from repro.core.library import paper_library_specs as jspecs
    from repro_torch.core.library import ModelLibrary as TLibrary
    from repro_torch.core.library import paper_library_specs as tspecs
    jlib, tlib = JLibrary(jspecs(512)), TLibrary(tspecs(512))
    assert tlib.names == jlib.names
    for k, (je, te) in enumerate(zip(jlib.experts, tlib.experts)):
        jlib.set_params(je.name, None, 1000 + k)
        tlib.set_params(te.name, None, 1000 + k)
        assert te.n_params == je.n_params == 1000 + k
        assert te.describe() == je.describe()
    model = torch.nn.Linear(2, 2)
    tlib.set_params("mathbert-analog", model, 6)
    assert tlib[9].params is model and tlib[9].n_params == 6
    for lib in (jlib, tlib):
        with pytest.raises(KeyError, match="no-such-expert"):
            lib.set_params("no-such-expert", None, 1)
    port = bridge.library_from_jax(tiny_library, device="cpu")
    assert port.names == [e.name for e in tiny_library.experts]
    assert [e.describe() for e in port.experts] == [
        e.describe() for e in tiny_library.experts]
