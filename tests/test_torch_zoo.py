"""The zoo's configs end to end: the port's models (weights carried by
``bridge.model_from_jax`` from ``repro.models.model.init_model``)
against the JAX package's on the same numpy inputs.

* Every config equals the JAX one field by field through
  ``bridge.model_config_from``, in full and ``reduced()``; the registry
  lists the JAX package's ten ids in its order.
* For each config's ``reduced()`` variant: prefill logits, every
  layer's KV cache (capacity S + 4) or Mamba state, and 4 greedy decode
  steps (the MoE decoders route and drop per call, as the reference
  does; jamba's one 8-layer unit holds Mamba, attention and MoE) through
  the port's ``prefill_step`` / ``serve_step`` (``device="cpu"``)
  against ``repro.models.model.prefill`` / ``decode_step`` + argmax
  (``attn_impl="xla"``; the Pallas kernel does not run in interpret
  mode under jax 0.9, and ``attention_ref`` is its oracle in
  ``tests/test_torch_attention.py``).  The window configs also with an
  8-slot window, so the rings roll in the prefill and wrap in decode.
  hubert is an encoder: prefill only, from embeddings; qwen2-vl
  prefills from embeddings and decodes tokens.
* gemma3's 34 layers get the reference's windows and cache lengths.
* ``launch.specs.applicable`` and the batch layouts for every config x
  ``INPUT_SHAPES`` entry.
* The embedding scale in bf16, element for element.

Tolerance: f32 logits within 1e-4 of the largest logit, caches and
Mamba states within 1e-5 (rtol and atol) per op; greedy tokens
identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import PORTED, get_config, list_archs
from repro_torch.launch import specs as tspecs
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.models.common import INPUT_SHAPES, AttnConfig, ModelConfig
from torch_threads import one_torch_thread  # noqa: F401

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.common import INPUT_SHAPES as JSHAPES  # noqa: E402

ZOO = ["tinyllama-1.1b", "qwen1.5-0.5b", "starcoder2-15b", "gemma3-4b",
       "hubert-xlarge", "qwen2-vl-72b", "qwen2-moe-a2.7b", "grok-1-314b",
       "jamba-v0.1-52b"]
LOGIT_REL = 1e-4
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS = 2, 12, 4


def _fields_equal(port, ref):
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _fields_equal(got, want)
        else:
            assert got == want, (f.name, got, want)


@pytest.mark.parametrize("arch", ZOO)
def test_config_matches_the_reference(arch):
    port, ref = get_config(arch), jget_config(arch)
    _fields_equal(port, ref)
    assert port == bridge.model_config_from(ref)
    _fields_equal(port.reduced(), ref.reduced())
    assert port.reduced().max_seq_len == 2048


def test_registry():
    assert list_archs() == list(PORTED) == jlist_archs()
    assert set(ZOO) | {"xlstm-1.3b"} == {get_config(a).name
                                         for a in list_archs()}
    for arch in list_archs():
        assert get_config(arch) == bridge.model_config_from(
            jget_config(arch))
    with pytest.raises(ValueError, match="not an architecture"):
        get_config("llama-7b")


def _jcfg(arch, window=None):
    cfg = jget_config(arch).reduced(d_model=64)
    if window is not None:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, sliding_window=window))
    return cfg


def _jax_layer_state(jstate, cfg, i):
    """Layer i's state from the JAX package's stacked units / rem."""
    P = len(cfg.layer_pattern)
    U = cfg.num_layers // P
    u, j = divmod(i, P)
    if u < U:
        return {k: v[u] for k, v in jstate["units"][f"l{j}"].items()}
    return jstate["rem"][f"l{j}"]


def _rel_close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= LOGIT_REL * np.abs(want).max(), err


CASES = [(a, None) for a in ZOO] + [("starcoder2-15b", 8), ("gemma3-4b", 8)]


@pytest.mark.parametrize("arch,window", CASES,
                         ids=[f"{a}-w{w}" if w else a for a, w in CASES])
def test_prefill_cache_and_greedy_decode_match(arch, window):
    jcfg = _jcfg(arch, window)
    params, _ = jm.init_model(jax.random.PRNGKey(7), jcfg)
    model = bridge.model_from_jax(params, bridge.model_config_from(jcfg),
                                  device="cpu")
    rng = np.random.default_rng(3)
    if tspecs.takes_embeds(model.cfg):
        x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
        jbatch, tbatch = {"embeds": jnp.asarray(x)}, {"embeds": x}
    else:
        x = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        jbatch, tbatch = {"tokens": jnp.asarray(x)}, {"tokens": x}
    cap = S + STEPS
    jlog, jst = jm.prefill(params, jcfg, jbatch, cache_capacity=cap)
    with torch.inference_mode():
        tlog, _ = tm.prefill(model, {k: torch.from_numpy(v)
                                     for k, v in tbatch.items()},
                             cache_capacity=cap)
    _rel_close(tlog, jlog)
    last, tst = prefill_step(model, tbatch, cache_capacity=cap, device="cpu")
    _rel_close(last, jlog[:, -1])
    for i, st in enumerate(tst):
        if "k" in st:
            w = tattn.layer_window(model.cfg, i)
            assert st["k"].shape[1] == (w if w else cap)
    _states_close(tst, jst, jcfg)
    if jcfg.is_encoder:
        ok, _ = tspecs.applicable(model.cfg, INPUT_SHAPES["decode_32k"])
        assert not ok
        return
    jtok = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = last.argmax(-1).to(torch.int32)[:, None]
    for t in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jd, jst = jm.decode_step(params, jcfg, {"tokens": jtok}, jst, S + t)
        with torch.inference_mode():
            td, _ = tm.decode_step(model, {"tokens": ttok}, tst, S + t)
        _rel_close(td, jd)
        ttok, tst = serve_step(model, tst, ttok, S + t, device="cpu")
        jtok = jnp.argmax(jd, -1).astype(jnp.int32)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _states_close(tst, jst, jcfg)


def _states_close(tst, jst, jcfg):
    """Every layer's KV cache (k, v) or Mamba state (h, conv)."""
    for i, st in enumerate(tst):
        ref = _jax_layer_state(jst, jcfg, i)
        assert set(st) == set(ref)
        for name in ref:
            np.testing.assert_allclose(st[name].float().numpy(),
                                       np.asarray(ref[name]), **CACHE_TOL)


def test_gemma_layer_windows_and_caches_match_the_reference():
    """The reference scans 5 units whose blocks get their index within
    the unit (0-5) and runs 4 remainder layers as 30-33; the port counts
    layers 0-33.  Both give gemma3's 34 layers the same windows, so the
    same decode caches (1024-slot rings, and 5 global layers)."""
    port, ref = get_config("gemma3-4b"), jget_config("gemma3-4b")
    U = ref.num_layers // len(ref.layer_pattern)
    P = len(ref.layer_pattern)
    want = [jattn.layer_window(ref, i % P) for i in range(U * P)]
    want += [jattn.layer_window(ref, U * P + j)
             for j in range(ref.num_layers - U * P)]
    got = [tattn.layer_window(port, i) for i in range(port.num_layers)]
    assert got == want
    assert got.count(0) == 5 and len(got) == 34
    cache_len = 1500
    jstate = jax.eval_shape(lambda: jm.init_decode_state(ref, 1, cache_len))
    small = dataclasses.replace(port, d_model=8, num_heads=2, num_kv_heads=1,
                                head_dim=4)
    tstate = tm.init_decode_state(small, 1, cache_len, device="cpu")
    for i, st in enumerate(tstate):
        u, j = divmod(i, P)
        want = (jstate["units"][f"l{j}"]["k"].shape[2] if u < U
                else jstate["rem"][f"l{j}"]["k"].shape[1])
        assert st["k"].shape[1] == want == (1024 if got[i] else cache_len)
        assert st["k"].dtype == torch.bfloat16 and not st["k"].any()


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ZOO + ["xlstm-1.3b"])
def test_specs_match_the_reference(arch, shape):
    port, ref = get_config(arch), jget_config(arch)
    pshape, rshape = INPUT_SHAPES[shape], JSHAPES[shape]
    assert dataclasses.asdict(pshape) == dataclasses.asdict(rshape)
    assert tspecs.applicable(port, pshape) == jspecs.applicable(ref, rshape)
    for got, want in ((tspecs.batch_specs(port, pshape),
                       jspecs.batch_specs(ref, rshape)),
                      (tspecs.decode_token_specs(port, pshape),
                       jspecs.decode_token_specs(ref, rshape))):
        assert set(got) == set(want)
        for name, (shp, dt) in got.items():
            assert shp == want[name].shape
            assert str(dt).removeprefix("torch.") == str(want[name].dtype)


def test_embed_scale_rounds_the_factor_like_the_reference():
    """bf16 activations of an ``embed_scale`` config (gemma3's d 2560):
    the first block's input, port vs ``repro.models.model._embed_in``,
    element for element.  The reference rounds sqrt(2560) to bf16
    (50.5) before the multiply; multiplying by the f32 50.596 rounds
    about a third of the products differently."""
    d = 2560
    cfg = ModelConfig(name="t", num_layers=1, d_model=d, num_heads=2,
                      num_kv_heads=1, head_dim=8, d_ff=8, vocab_size=500,
                      attn=AttnConfig(), embed_scale=True, dtype="bfloat16")
    jcfg = dataclasses.replace(jget_config("gemma3-4b"), d_model=d,
                               vocab_size=500, dtype="bfloat16")
    table = np.random.default_rng(0).normal(size=(500, d)).astype(np.float32)
    tokens = np.arange(500, dtype=np.int32)[None]
    jtable = jnp.asarray(table).astype(jnp.bfloat16)
    ref = jm._embed_in({"embed": {"table": jtable}}, jcfg,
                       {"tokens": jnp.asarray(tokens)})
    model = tm.init_model(cfg, device="cpu")
    model.embed["table"].data = bridge._tensor(np.asarray(jtable))
    seen = []

    class Seen(Exception):
        pass

    def stop(block, args):   # keep the first block's input and stop
        seen.append(args[0])
        raise Seen

    model.layers[0].register_forward_pre_hook(stop)
    with torch.inference_mode(), pytest.raises(Seen):
        model(torch.from_numpy(tokens), mode="encode")
    got = seen[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_steps_take_embeds_and_cache_capacity():
    """``prefill_step`` takes an ``embeds`` batch, sizes full-attention
    caches by ``cache_capacity`` and window rings by their window; the
    decode from it matches a prefill one token longer."""
    cfg = dataclasses.replace(get_config("gemma3-4b").reduced(d_model=64),
                              attn=dataclasses.replace(
                                  get_config("gemma3-4b").attn,
                                  sliding_window=4))
    model = tm.init_model(cfg, seed=1, device="cpu")
    x = torch.randn(1, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    last, state = prefill_step(model, {"embeds": x}, cache_capacity=16,
                               device="cpu")
    assert last.shape == (1, cfg.vocab_size) and last.dtype == torch.float32
    assert [st["k"].shape[1] for st in state] == [4] * 5 + [16]
    emb = torch.randn(1, 1, cfg.d_model, generator=torch.Generator()
                      .manual_seed(1))
    with torch.inference_mode():
        dec, _ = tm.decode_step(model, {"embeds": emb}, state, 9)
        full, _ = tm.prefill(model, {"embeds": torch.cat([x, emb], 1)})
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), atol=1e-4)
