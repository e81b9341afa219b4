"""The port's KV cache and cached decode attention against the JAX
package's (``repro.models.attention``), and mRoPE against
``repro.models.layers.apply_mrope``, on the same numpy inputs.

* ``init_kv_cache``: shapes, types, zeros;
* ``prefill_cache_from_kv``: full-attention capacity padding (and a
  capacity below S, which keeps all S), and the window ring with
  S < W, S == W, S > W and S a multiple of W;
* ``attend_decode``: one step from a prefill's cache (full, window,
  GQA, softcap, bias, mRoPE), and a ring that wraps, token by token
  from an empty cache past the window (the reference's
  ``tests/test_attention.py`` ring case), both also against a full
  forward one token longer;
* ``apply_mrope`` with three different position streams.

Tolerance: caches are built by copies, so they must be equal (f32 and
bf16).  Decode outputs in f32 rtol=atol=1e-5 (sums in another order on
the CPU); in bf16, where both frameworks round each product in bf16,
within 2 bf16 ulps of the output's largest magnitude.  Against a full
forward atol 1e-4, the reference's own bound.
"""

import numpy as np
import pytest
import torch

from repro_torch.bridge import model_config_from
from repro_torch.models import attention as tattn
from repro_torch.models.layers import apply_mrope

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.common import AttnConfig, ModelConfig  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULPS = 2


def _jcfg(heads=4, kv=2, window=0, softcap=0.0, bias=False, mrope=False,
          dtype="float32", d=64, hd=0):
    return ModelConfig(
        name="t", family="dense", num_layers=1, d_model=d, num_heads=heads,
        num_kv_heads=kv, d_ff=128, vocab_size=64, head_dim=hd,
        attn=AttnConfig(rope_theta=10000.0, sliding_window=window,
                        window_pattern="all_local" if window else "all_global",
                        softcap=softcap, qkv_bias=bias, use_mrope=mrope,
                        mrope_sections=(2, 3, 3)),
        dtype=dtype)


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {"wq": rng.normal(size=(d, H, hd)) / np.sqrt(d),
         "wk": rng.normal(size=(d, KV, hd)) / np.sqrt(d),
         "wv": rng.normal(size=(d, KV, hd)) / np.sqrt(d),
         "wo": rng.normal(size=(H, hd, d)) / np.sqrt(H * hd)}
    if cfg.attn.qkv_bias:
        p.update(bq=rng.normal(size=(H, hd)) / 4,
                 bk=rng.normal(size=(KV, hd)) / 4,
                 bv=rng.normal(size=(KV, hd)) / 4)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(arrays: dict, dtype: str):
    """numpy f32 arrays as (JAX, torch) dicts in ``dtype``."""
    j = {k: jnp.asarray(v).astype(dtype) for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in arrays.items()}
    return j, t


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tnp(x):
    return x.float().numpy()


def _positions(B, S, mrope, offset=0):
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) + offset, (B, S))
    if mrope:   # three different streams, as an image's tokens have
        pos = np.stack([pos, pos // 2, pos % 3 + offset])
    return pos.copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,kv,hd", [(7, 2, 16), (32, 4, 8)])
def test_init_kv_cache_matches(dtype, T, kv, hd):
    jcfg = _jcfg(heads=4, kv=kv, hd=hd, dtype=dtype)
    ref = jattn.init_kv_cache(3, T, jcfg, jnp.dtype(dtype))
    got = tattn.init_kv_cache(3, T, model_config_from(jcfg),
                              getattr(torch, dtype), device="cpu")
    for name in ("k", "v"):
        assert tuple(got[name].shape) == ref[name].shape == (3, T, kv, hd)
        assert got[name].dtype == getattr(torch, dtype)
        assert not got[name].any()


# (S, window, capacity): full attention at its own length, padded, and
# given a capacity below S (kept whole); the ring short of, at, past and
# at twice its window
CACHE_CASES = [(6, 0, None), (6, 0, 10), (6, 0, 4), (6, 0, 1), (5, 8, None),
               (8, 8, None), (13, 8, None), (16, 8, None), (21, 8, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,capacity", CACHE_CASES)
def test_prefill_cache_from_kv_matches(S, window, capacity, dtype):
    rng = np.random.default_rng(S + window)
    kv = {"k": rng.normal(size=(2, S, 2, 8)).astype(np.float32),
          "v": rng.normal(size=(2, S, 2, 8)).astype(np.float32)}
    j, t = _both(kv, "float32")
    ref = jattn.prefill_cache_from_kv(j["k"], j["v"], window,
                                      jnp.dtype(dtype), capacity=capacity)
    got = tattn.prefill_cache_from_kv(t["k"], t["v"], window,
                                      getattr(torch, dtype),
                                      capacity=capacity)
    for name in ("k", "v"):
        assert got[name].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_tnp(got[name]), _np(ref[name]))
    if 0 < window < S:   # the ring invariant: slot == position % window
        for pos in range(S - window, S):
            assert torch.equal(got["k"][:, pos % window],
                               t["k"][:, pos].to(getattr(torch, dtype)))


def _assert_decode_close(got, ref, dtype):
    g, r = _tnp(got), _np(ref)
    if dtype == "float32":
        np.testing.assert_allclose(g, r, **TOL)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        assert np.abs(g - r).max() <= BF16_ULPS * ulp


# (heads, kv, window, softcap, bias, mrope, S): one step after a prefill
DECODE_CASES = [(4, 2, 0, 0.0, False, False, 12),
                (4, 4, 0, 0.0, True, False, 12),
                (4, 1, 8, 0.0, False, False, 5),
                (4, 2, 8, 0.0, False, False, 8),
                (4, 2, 8, 20.0, False, False, 19),
                (4, 2, 0, 0.0, True, True, 9)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,kv,window,softcap,bias,mrope,S",
                         DECODE_CASES)
def test_attend_decode_matches(heads, kv, window, softcap, bias, mrope, S,
                               dtype):
    jcfg = _jcfg(heads, kv, window, softcap, bias, mrope, dtype)
    tcfg = model_config_from(jcfg)
    jp, tp = _both(_params(jcfg), dtype)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S + 1, jcfg.d_model)).astype(np.float32)
    jx, tx = (a["x"] for a in _both({"x": x}, dtype))
    pos = _positions(2, S + 1, mrope)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    cap = S + 3
    _, (jk, jv) = jattn.attend_full(jp, jx[:, :S], jcfg, jpos[..., :S],
                                    window=window)
    jcache = jattn.prefill_cache_from_kv(jk, jv, window, jnp.dtype(dtype),
                                         capacity=cap)
    _, (tk, tv) = tattn.attend_full(tp, tx[:, :S], tcfg, tpos[..., :S],
                                    window=window)
    tcache = tattn.prefill_cache_from_kv(tk, tv, window,
                                         getattr(torch, dtype), capacity=cap)
    for name in ("k", "v"):
        _assert_decode_close(tcache[name], jcache[name], dtype)
    jy, jnew = jattn.attend_decode(jp, jx[:, S:], jcache, S, jcfg,
                                   jpos[..., S:], window=window)
    # the JAX cache carried over, so the step alone is compared
    jcache_t = {n: torch.tensor(_np(a)).to(getattr(torch, dtype))
                for n, a in jcache.items()}
    before = {n: a.clone() for n, a in jcache_t.items()}
    ty, tnew = tattn.attend_decode(tp, tx[:, S:], jcache_t, S, tcfg,
                                   tpos[..., S:], window=window)
    assert all(torch.equal(before[n], jcache_t[n]) for n in before)
    _assert_decode_close(ty, jy, dtype)
    for name in ("k", "v"):
        _assert_decode_close(tnew[name], jnew[name], dtype)
    if dtype == "float32":   # and one step equals a forward over S + 1
        full, _ = tattn.attend_full(tp, tx, tcfg, tpos, window=window)
        np.testing.assert_allclose(ty[:, 0].numpy(), full[:, S].numpy(),
                                   atol=1e-4)


@pytest.mark.parametrize("W,S", [(8, 20), (8, 8), (5, 16)])
def test_ring_buffer_wraps(W, S):
    """From an empty ring of W slots, decode S + 1 tokens one by one:
    each step against the reference's, and the last against a full
    forward over all S + 1 (the ring then holds exactly the last W)."""
    jcfg = _jcfg(window=W)
    tcfg = model_config_from(jcfg)
    jp, tp = _both(_params(jcfg, seed=W), "float32")
    x = np.random.default_rng(S).normal(
        size=(1, S + 1, jcfg.d_model)).astype(np.float32)
    pos = _positions(1, S + 1, False)
    jc = jattn.init_kv_cache(1, W, jcfg, jnp.float32)
    tc = tattn.init_kv_cache(1, W, tcfg, torch.float32, device="cpu")
    for t in range(S + 1):
        jy, jc = jattn.attend_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, t,
                                     jcfg, jnp.asarray(pos[:, t:t + 1]),
                                     window=W)
        ty, tc = tattn.attend_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                                     t, tcfg,
                                     torch.from_numpy(pos[:, t:t + 1]),
                                     window=W)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    full, _ = tattn.attend_full(tp, torch.from_numpy(x), tcfg,
                                torch.from_numpy(pos), window=W)
    np.testing.assert_allclose(ty[:, 0].numpy(), full[:, S].numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128),
                                         ((2, 3, 3), 16), ((2, 2, 2), 16)])
def test_apply_mrope_matches(sections, hd):
    """Three different position streams (the last section also takes
    the slots past the sections' sum when they fall short)."""
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 11, 3, hd)).astype(np.float32)
    pos = _positions(2, 11, True, offset=4)
    ref = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                              1_000_000.0)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections,
                      1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # equal streams reduce to RoPE
    same = np.stack([pos[0]] * 3)
    from repro_torch.models.layers import apply_rope
    np.testing.assert_allclose(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same), sections,
                    1e4).numpy(),
        apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]),
                   1e4).numpy(), **TOL)
