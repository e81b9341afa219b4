"""The port's attention against the JAX package's.

* ``repro_torch.kernels.flash_attention.ops.flash_attention`` on CPU
  tensors (its plain version) against ``repro.kernels.flash_attention
  .ref.attention_ref`` — causal, window, softcap and GQA, hd 32 and 40,
  S 32 and 128.  (The Pallas kernel itself does not run in interpret
  mode under jax 0.9, so the reference is its oracle.)
* ``repro_torch.models.attention.attend_full`` against
  ``repro.models.attention.attend_full(impl="xla")`` on the same
  weights, the function the JAX engine runs.

Also bf16 inputs (the zoo's type) and head_dim 64-256, and the
backward's refusal of what its kernel does not take.

Tolerance: f32 outputs agree to rtol=1e-5, atol=1e-5 (different
reduction orders on the CPU).  bf16: both compute in f32 from the same
bf16 inputs and round once to bf16, so each element within one bf16
ulp of its magnitude plus 1e-5.  The kernel itself is held against the
plain version on the card in ``tests/test_torch_gpu.py``.
"""

import dataclasses
import numpy as np
import pytest
import torch

from repro_torch.bridge import model_config_from
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as tattn

# the JAX package is the reference; a host without it (the GPU host)
# skips this module and runs tests/test_torch_gpu.py
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core.library import _enc as jax_enc  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402


RTOL = ATOL = 1e-5
CASES = [  # (S, H, KV, hd, causal, window, softcap)
    (32, 2, 2, 32, False, 0, 0.0),
    (128, 4, 4, 40, False, 0, 0.0),
    (128, 4, 2, 32, True, 0, 0.0),
    (32, 4, 1, 40, True, 8, 0.0),
    (128, 2, 2, 32, False, 16, 30.0),
    (32, 2, 2, 40, True, 0, 5.0),
]


WIDE_CASES = [  # (S, H, KV, hd, causal, window, softcap), bf16 and f32
    (40, 8, 4, 256, True, 0, 0.0),      # gemma3 global
    (40, 8, 4, 256, True, 16, 0.0),     # gemma3 local, S past the window
    (48, 8, 1, 128, True, 32, 0.0),     # starcoder2-like GQA, window
    (32, 8, 2, 64, True, 0, 0.0),       # tinyllama-like GQA
    (32, 4, 4, 80, False, 0, 0.0),      # hubert's hd, bidirectional
    (24, 2, 2, 136, False, 0, 30.0),
]


def _qkv(S, H, KV, hd, seed=0, B=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    return q, k, v


def _to_bh(a, H):
    """(B, S, KV, hd) -> (B*H, S, hd), repeating KV heads as GQA does."""
    B, S, KV, hd = a.shape
    a = np.repeat(a, H // KV, axis=2)
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


@pytest.mark.parametrize("S,H,KV,hd,causal,window,softcap", CASES)
def test_plain_matches_attention_ref(S, H, KV, hd, causal, window, softcap):
    q, k, v = _qkv(S, H, KV, hd)
    out = fa_ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, softcap=softcap)
    ref = attention_ref(jnp.asarray(_to_bh(q, H)), jnp.asarray(_to_bh(k, H)),
                        jnp.asarray(_to_bh(v, H)), causal=causal,
                        window=window, softcap=softcap)
    B = q.shape[0]
    ref = np.asarray(ref).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S,hd,causal,window,softcap", [
    (32, 32, False, 0, 0.0), (128, 40, False, 0, 0.0),
    (32, 40, True, 8, 20.0)])
def test_attend_full_matches_xla(S, hd, causal, window, softcap):
    H = 4
    jcfg = jax_enc("t", 1, H * hd, H, 64, 64)
    jcfg = dataclasses.replace(jcfg, attn=dataclasses.replace(
        jcfg.attn, causal=causal, softcap=softcap))
    rng = np.random.default_rng(4)
    d = H * hd
    p = {"wq": rng.normal(size=(d, H, hd)), "wk": rng.normal(size=(d, H, hd)),
         "wv": rng.normal(size=(d, H, hd)), "wo": rng.normal(size=(H, hd, d))}
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    ref, _ = jattn.attend_full({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), jcfg, jnp.asarray(pos),
                               window=window, impl="xla")
    out, _ = tattn.attend_full({k: torch.from_numpy(v)
                                for k, v in p.items()},
                               torch.from_numpy(x), model_config_from(jcfg),
                               torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,hd,causal,window,softcap", WIDE_CASES)
def test_plain_matches_attention_ref_bf16_and_wide(S, H, KV, hd, causal,
                                                   window, softcap, dtype):
    q, k, v = _qkv(S, H, KV, hd, seed=hd)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    out = fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 softcap=softcap)
    assert out.dtype == getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(_to_bh(a, H)).astype(dtype) for a in (q, k, v))
    ref = attention_ref(jq, jk, jv, causal=causal, window=window,
                        softcap=softcap)
    assert ref.dtype == jnp.dtype(dtype)
    B = q.shape[0]
    ref = np.asarray(ref.astype(jnp.float32)).reshape(
        B, H, S, hd).transpose(0, 2, 1, 3)
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    else:
        mag = np.maximum(np.abs(got), np.abs(ref)).clip(2.0 ** -126)
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        assert (np.abs(got - ref) <= ulp + ATOL).all()


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.float32, 256),
                                      (torch.bfloat16, 256)])
def test_backward_refuses_what_its_kernel_does_not_take(dtype, hd):
    """The backward kernel is f32 up to hd 128: ``flash_attention_bwd``
    and ``_FlashAttention`` refuse the rest on any device, before
    anything runs, pointing at ROADMAP.md (their CPU message path)."""
    q = torch.zeros(1, 4, 2, hd, dtype=dtype)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fa_ops.flash_attention_bwd(q, q, q, lse, q)
    with pytest.raises(NotImplementedError, match="head_dim 128"):
        fa_ops._FlashAttention.apply(q, q, q, True, 0, 0.0)
    # the forward alone still runs, and the plain version differentiates
    x = q.clone().requires_grad_(True)
    fa_ops.flash_attention(x, x, x).float().sum().backward()
    assert x.grad.shape == x.shape
