"""The reduced xLSTM end to end: the port's model (weights carried by the
bridge from ``repro.models.model.init_model``) against the JAX
package's on the same tokens.  ``forward`` train logits, ``prefill``
logits and every layer's state, ``decode_step`` logits, and 8 greedy
tokens through the port's ``prefill_step``/``serve_step`` against the
JAX package's ``prefill`` + ``decode_step`` + argmax (what its
``build_prefill_step``/``build_decode_step`` jit).  Also the port's own
decode-matches-prefill check and the config copy.

Tolerance: f32 logits and states atol=5e-4, rtol=1e-4 (sums in
another order through 8-10 layers move logits near 0 by up to about
2e-4); greedy tokens identical.  In bf16 (the config's type) each
layer, fed the same input, agrees with the JAX layer to 2 bf16 ulps of
its largest output: the two frameworks round products and activations
at other places, and through many random layers those 1-ulp
differences grow, so whole-model bf16 logits are not compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import launches
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models import model as tm
from torch_threads import one_torch_thread  # noqa: F401

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.layers import apply_embedding  # noqa: E402

TOL = dict(atol=5e-4, rtol=1e-4)
ARCH = "xlstm-1.3b"


def _jcfg(num_layers):
    """The JAX package's reduced xLSTM: one unit of 8 layers at d=64
    (mLSTM dh 64, sLSTM dh 32, SwiGLU d_ff 192); at 10 layers one unit
    and two remainder layers."""
    cfg = jget_config(ARCH).reduced(d_model=64)
    return dataclasses.replace(cfg, num_layers=num_layers)


@pytest.fixture(scope="module", params=[8, 10], ids=["1unit", "1unit+2"])
def pair(request):
    jcfg = _jcfg(request.param)
    params, _ = jm.init_model(jax.random.PRNGKey(request.param), jcfg)
    model = bridge.model_from_jax(params, bridge.model_config_from(jcfg),
                                  device="cpu")
    return jcfg, params, model


def _tokens(V, B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **TOL)


def _jax_layer_state(jstate, cfg, i):
    """Layer i's state from the JAX package's stacked units / rem."""
    P = len(cfg.layer_pattern)
    U = cfg.num_layers // P
    u, j = divmod(i, P)
    if u < U:
        return {k: v[u] for k, v in jstate["units"][f"l{j}"].items()}
    return jstate["rem"][f"l{j}"]


def test_train_logits(pair):
    jcfg, params, model = pair
    toks = _tokens(jcfg.vocab_size)
    logits, _, _ = jm.forward(params, jcfg, {"tokens": jnp.asarray(toks)},
                              mode="train", remat=False)
    with torch.no_grad():
        _close(tm.forward(model, {"tokens": torch.from_numpy(toks)}), logits)


def test_prefill_states_and_decode_step(pair):
    jcfg, params, model = pair
    toks = _tokens(jcfg.vocab_size, seed=1)
    S = toks.shape[1] - 1
    jlog, jst = jm.prefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :S])})
    launches.reset_launch_counts()
    with torch.no_grad():
        tlog, tst = tm.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])})
    assert launches.launch_counts()["mlstm_scan"] == 0   # CPU: plain path
    _close(tlog, jlog)
    assert len(tst) == jcfg.num_layers
    for i, st in enumerate(tst):
        ref = _jax_layer_state(jst, jcfg, i)
        assert set(st) == set(ref), i
        for leaf in ref:
            _close(st[leaf], ref[leaf])
    jd, _ = jm.decode_step(params, jcfg, {"tokens": jnp.asarray(toks[:, S:])},
                           jst, S)
    with torch.no_grad():
        td, _ = tm.decode_step(model, {"tokens": torch.from_numpy(toks[:, S:])},
                               tst, S)
    _close(td, jd)


def test_greedy_tokens_match_the_jax_steps(pair):
    jcfg, params, model = pair
    toks = _tokens(jcfg.vocab_size, seed=2)
    S = toks.shape[1]
    prefill = jax.jit(lambda p, t: jm.prefill(p, jcfg, {"tokens": t}))
    decode = jax.jit(lambda p, t, st, i: jm.decode_step(
        p, jcfg, {"tokens": t}, st, i))
    jlog, jst = prefill(params, jnp.asarray(toks))
    nxt = jnp.argmax(jlog[:, -1].astype(jnp.float32), -1).astype(
        jnp.int32)[:, None]
    want = [np.asarray(nxt)]
    for t in range(7):
        lg, jst = decode(params, nxt, jst, S + t)
        nxt = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(nxt))
    last, st = prefill_step(model, {"tokens": toks}, device="cpu")
    assert last.dtype == torch.float32 and last.shape == (2, jcfg.vocab_size)
    _close(last, jlog[:, -1])
    tok = last.argmax(-1).to(torch.int32)[:, None]
    got = [tok.numpy()]
    for t in range(7):
        tok, st = serve_step(model, st, tok, S + t, device="cpu")
        assert tok.dtype == torch.int32 and tok.shape == (2, 1)
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


def test_decode_matches_prefill_next_token(pair):
    """Decoding one token from a prefill's state gives the logits of a
    prefill over one more token."""
    jcfg, _, model = pair
    toks = torch.from_numpy(_tokens(jcfg.vocab_size, B=1, S=17, seed=3))
    with torch.no_grad():
        full, _ = tm.prefill(model, {"tokens": toks})
        _, st = tm.prefill(model, {"tokens": toks[:, :16]})
        dec, _ = tm.decode_step(model, {"tokens": toks[:, 16:]}, st, 16)
    _close(dec, full[:, 16])


def test_bf16_layers_match_within_two_ulps():
    """Each layer of the bf16 model (one unit: 7 mLSTM + 1 sLSTM, with
    the reduced config's SwiGLU), given the port's input to it, against
    the JAX block on the same input in prefill mode."""
    jcfg = dataclasses.replace(_jcfg(8), dtype="bfloat16")
    params, _ = jm.init_model(jax.random.PRNGKey(5), jcfg)
    model = bridge.model_from_jax(params, bridge.model_config_from(jcfg),
                                  device="cpu")
    toks = _tokens(jcfg.vocab_size, S=64, seed=5)
    outs = []
    for block in model.layers:
        block.register_forward_hook(
            lambda m, a, o: outs.append(o[0].float().numpy()))
    with torch.no_grad():
        tm.prefill(model, {"tokens": torch.from_numpy(toks)})
    x = apply_embedding(params["embed"], jnp.asarray(toks))
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1])[None], toks.shape)
    for i, kind in enumerate(jcfg.layer_pattern):
        p = jax.tree.map(lambda a: a[0], params["units"][f"l{i}"])
        xin = jnp.asarray(outs[i - 1]).astype(jnp.bfloat16) if i else x
        y, _, _ = jblocks.apply_block(p, xin, jcfg, kind, False,
                                      mode="prefill", layer_idx=i,
                                      positions=pos)
        y = np.asarray(y, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7)
        assert np.abs(y - outs[i]).max() <= 2 * ulp, (i, kind)


def test_param_count_matches_jax(pair):
    jcfg, params, model = pair
    assert tm.count_params(model) == jm.count_params(params)


def test_config_copy_matches_jax():
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    assert get_config("xlstm_13b") is tcfg
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(got):
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), \
                    (f.name, g.name)
        else:
            assert got == want, f.name
    # fields the port does not carry keep the values it assumes
    assert jcfg.moe is None and not jcfg.is_encoder and jcfg.embed_inputs
    assert bridge.model_config_from(jcfg) == tcfg
    assert bridge.model_config_from(jcfg.reduced(d_model=64)) == \
        tcfg.reduced(d_model=64)


def test_unported_configs_raise():
    """Every zoo config is ported since the MoE and Mamba blocks; what
    is not an architecture or a block kind of the zoo still raises."""
    with pytest.raises(ValueError, match="not an architecture"):
        get_config("jamba-v0.2")
    jamba = jget_config("jamba-v0.1-52b")
    assert bridge.model_config_from(jamba) == get_config("jamba-v0.1-52b")
    with pytest.raises(ValueError, match="block kind"):
        bridge.model_config_from(dataclasses.replace(
            jamba, layer_pattern=("rwkv",) * 8))
    cfg = get_config(ARCH).reduced(d_model=32)
    with pytest.raises(ValueError, match="block kind"):
        tm.init_model(dataclasses.replace(cfg, layer_pattern=("rwkv",),
                                          moe_pattern=(False,),
                                          num_layers=1), device="cpu")
    # attention prefill is ported since the KV cache: it returns one
    attn = dataclasses.replace(cfg, layer_pattern=("attn",),
                               moe_pattern=(False,), num_layers=1)
    model = tm.init_model(attn, device="cpu")
    _, state = tm.prefill(model, {"tokens": torch.zeros(1, 4,
                                                        dtype=torch.long)})
    assert state[0]["k"].shape == (1, 4, attn.num_kv_heads,
                                   attn.resolved_head_dim)
    # an MoE layer needs the config's moe
    with pytest.raises(ValueError, match="moe is None"):
        dataclasses.replace(cfg, moe_pattern=(True,) + (False,) * 7)
