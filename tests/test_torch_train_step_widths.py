"""The port's ``train_step`` against the JAX package's ``build_train_step``
at the attention shapes of the configs whose published widths train on
the card: starcoder2-15b, qwen2-vl-72b, hubert-xlarge, grok-1-314b and
jamba-v0.1-52b.

``reduced()`` gives every config head_dim 64, at most 4 heads and a GQA
ratio of 1 (4 heads, 4 kv heads): none of the shapes that reach the
attention kernel and its backward on the card.  Each narrow variant
here keeps its config's published head_dim, GQA ratio, softcap, mRoPE
sections, the encoder's non-causal attention, the MoE's top-k and its
norms and activations, and cuts the head count (by the GQA ratio, to
one kv head where the published ratio is above 1), the model width,
the vocabulary and the depth:

* starcoder2: hd 128, 12 query heads to 1 kv head (48:4), qkv bias,
  layernorm and gelu; its 4,096-token sliding window is scaled to 8
  tokens so that the window bites at S = 16, as the published one does
  at the card's S = 4,608;
* qwen2-vl: hd 128, 8:1 (64:8), mRoPE sections (16, 24, 24), qkv bias,
  embeddings in with MLM targets;
* hubert: hd 80, 2:2 (16:16), non-causal, an encoder with embeddings in;
* grok: hd 128, 6:1 (48:8), softcap 30, 8 experts top-2, the embedding
  scale;
* jamba: one 8-layer unit (7 Mamba layers, the attention layer, 4 MoE
  MLPs) at ``reduced()`` width, with hd 128 and 4:1 (32:8).

Both packages start from the same weights (the JAX ``init_model``,
carried by ``repro_torch.bridge``) and take 2 steps at lr 1e-3 on the
reference CLI's batches (``launch.train.arch_batches``, batch 2, seq
16), the reference on a 1 x 1 host mesh: the losses agree to rtol 1e-5
and the weights after 2 steps within 6 lr, as in
``tests/test_torch_train_step.py``.  On the CPU the kernels run their
plain versions; ``chip_smoke.py`` holds the kernels at these configs'
published shapes on the card.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.launch.steps import PerfKnobs, train_step
from repro_torch.launch.train import arch_batches
from repro_torch.optim import adamw_init
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.steps import PerfKnobs as JKnobs  # noqa: E402
from repro.launch.steps import build_train_step  # noqa: E402
from repro.models.common import InputShape  # noqa: E402
from repro.models.model import init_model as jinit_model  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402

LR = 1e-3
B, S, STEPS = 2, 16, 2
LOSS_RTOL = 1e-5
WINDOW = 8          # starcoder2's window, scaled below S

# (arch, fields laid over the published config)
NARROW = {
    "starcoder2-15b": dict(num_layers=2, d_model=256, num_heads=12,
                           num_kv_heads=1, head_dim=128, d_ff=512),
    "qwen2-vl-72b": dict(num_layers=2, d_model=256, num_heads=8,
                         num_kv_heads=1, head_dim=128, d_ff=512),
    "hubert-xlarge": dict(num_layers=2, d_model=160, num_heads=2,
                          num_kv_heads=2, head_dim=80, d_ff=480),
    "grok-1-314b": dict(num_layers=2, d_model=256, num_heads=6,
                        num_kv_heads=1, head_dim=128, d_ff=512),
    "jamba-v0.1-52b": dict(num_heads=4, num_kv_heads=1, head_dim=128),
}
# what each variant must keep of its published config
KEEP = {"starcoder2-15b": (128, 12, None, 0.0),
        "qwen2-vl-72b": (128, 8, (16, 24, 24), 0.0),
        "hubert-xlarge": (80, 1, None, 0.0),
        "grok-1-314b": (128, 6, None, 30.0),
        "jamba-v0.1-52b": (128, 4, None, 0.0)}


def narrow_config(arch):
    """The JAX package's narrow variant of ``arch`` (see the module
    docstring); jamba starts from its ``reduced()`` unit."""
    cfg = jget_config(arch)
    if arch == "jamba-v0.1-52b":
        cfg = cfg.reduced(num_layers=8)
    else:
        cfg = dataclasses.replace(cfg, vocab_size=512, dtype="float32",
                                  max_seq_len=2048)
    cfg = dataclasses.replace(cfg, name=cfg.name + "-narrow", **NARROW[arch])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=cfg.moe.d_ff_expert and 2 * cfg.d_model))
    if arch == "starcoder2-15b":
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, sliding_window=WINDOW))
    return cfg


def _host_mesh():
    """A 1 x 1 mesh with Auto axes (see tests/test_torch_train_step.py)."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("arch", list(NARROW))
def test_narrow_variant_keeps_the_published_attention(arch):
    cfg, pub = narrow_config(arch), jget_config(arch)
    hd, ratio, sections, softcap = KEEP[arch]
    assert cfg.resolved_head_dim == pub.resolved_head_dim == hd
    assert cfg.num_heads // cfg.num_kv_heads == ratio
    assert pub.num_heads // pub.num_kv_heads == ratio
    assert cfg.attn.softcap == pub.attn.softcap == softcap
    assert cfg.attn.causal == pub.attn.causal
    assert cfg.attn.use_mrope == pub.attn.use_mrope
    if sections:
        assert cfg.attn.mrope_sections == pub.attn.mrope_sections == sections
        assert sum(sections) == hd // 2
    if pub.moe is not None:
        assert cfg.moe.top_k == pub.moe.top_k
    assert (cfg.family, cfg.is_encoder, cfg.norm_kind, cfg.act,
            cfg.layer_pattern, cfg.moe_pattern) == (
        pub.family, pub.is_encoder, pub.norm_kind, pub.act,
        pub.layer_pattern, pub.moe_pattern)
    if arch == "starcoder2-15b":
        assert 0 < cfg.attn.sliding_window < S
        assert cfg.attn.window_pattern == pub.attn.window_pattern


@pytest.fixture(scope="module")
def reference():
    """Per arch: the JAX weights, the batches, the reference's losses and
    its weights after STEPS steps."""
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        jcfg = narrow_config(arch)
        params, _ = jinit_model(jax.random.PRNGKey(0), jcfg)
        batches = list(arch_batches(bridge.model_config_from(jcfg), STEPS,
                                    B, S))
        built = build_train_step(
            jcfg, InputShape(name="t", seq_len=S, global_batch=B,
                             kind="train"),
            _host_mesh(), JKnobs(donate=False), lr=LR)
        opt = jadamw_init(params)
        opt = {"step": opt.step, "mu": opt.mu, "nu": opt.nu}
        p, losses = params, []
        with _host_mesh():
            for b in batches:
                p, opt, loss = built.fn(p, opt, {k: jnp.asarray(v)
                                                 for k, v in b.items()})
                losses.append(float(loss))
        cache[arch] = (jcfg, params, batches, losses,
                       bridge.model_state(jax.device_get(p)))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", list(NARROW))
def test_train_step_at_published_attention_shapes(arch, reference):
    jcfg, params, batches, want_losses, want = reference(arch)
    model = bridge.model_from_jax(params, bridge.model_config_from(jcfg),
                                  device="cpu")
    opt = adamw_init(model)
    losses = [float(train_step(model, opt, b, knobs=PerfKnobs(), lr=LR,
                               device="cpu")) for b in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert opt.step == STEPS
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n in want:
        diff = np.abs(got[n].astype(np.float64) - want[n]).max()
        assert diff <= 6 * LR, (n, diff)
