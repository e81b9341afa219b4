"""The port's roofline (``repro_torch.launch.roofline``), op counter
(``repro_torch.launch.op_costs``) and dry run
(``repro_torch.launch.dryrun``) against the JAX package's
``repro.launch.roofline``, ``repro.launch.hlo_loops`` and
``repro.launch.specs``.

* ``model_flops`` and ``active_params`` equal the reference's for all
  ten configs at every input shape, from the port's parameter count on
  the meta device (equal to the reference's abstract one);
* ``Roofline`` terms equal the reference's under each of its presets;
  the port's default and constants are the h100 preset's;
* ``OpCounter``'s ``dot_flops`` equal ``loop_aware_totals``' on the
  reference's scanned, unrolled and nested examples
  (tests/test_hlo_loops.py, 8 x 2 x 4 x 64 x 64);
* ``OpCounter``'s ``dot_flops`` of a reduced config's prefill equal the
  reference's compiled prefill's ``loop_aware_totals``, exactly, once
  the two terms where the programs differ by design are named: XLA
  multiplies every (query, key) pair of attention where the kernel
  records the pairs the mask leaves (the reference is larger by
  4 B H hd (S T - pairs) a layer), and the mLSTM kernel records its
  whole L x L in-chunk tile where XLA's count leaves out the pairs past
  the diagonal (the port is larger by 4 B H dh (L^2 - L (L + 1) / 2) a
  layer and chunk), and at one chunk from a zero state XLA folds the
  normaliser's q n away (n is zero), which the kernel computes (the
  port is larger by 2 B H dh S a layer); and at S 256 on meta, the sLSTM's loop counted by
  trip count, equal;
* the kernels' aten ops are hidden from the counter (the plain versions
  on the CPU) while their recorded work is counted once;
* ``run_one``'s SKIP and OK match ``applicable`` for every pair (the
  reduced configs at a small shape of each kind); on meta the parameter
  bytes equal ``count_params`` x the parameters' type size, and at full
  width the reference's abstract parameter bytes; the CLI writes one
  record without a card and refuses an unknown ``--mesh`` (the pod
  meshes: ``tests/test_torch_dryrun_mesh.py``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import dryrun, op_costs
from repro_torch.launch import roofline as troof
from repro_torch.launch.steps import PerfKnobs
from repro_torch.models import model as tm
from repro_torch.models.common import INPUT_SHAPES, InputShape
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.hlo_loops import loop_aware_totals  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.common import INPUT_SHAPES as JSHAPES  # noqa: E402


@pytest.fixture(scope="module")
def full_params():
    """arch -> (the port's parameter count and bytes on meta, the
    reference's abstract ones)."""
    out = {}
    for arch in list_archs():
        model = tm.init_model(get_config(arch), device="meta")
        shapes = jax.eval_shape(
            lambda: jm.init_model(jax.random.PRNGKey(0),
                                  jget_config(arch))[0])
        leaves = jax.tree.leaves(shapes)
        out[arch] = (tm.count_params(model),
                     sum(p.numel() * p.element_size()
                         for p in model.parameters()),
                     sum(int(x.size) for x in leaves),
                     sum(int(x.size) * x.dtype.itemsize for x in leaves))
    return out


def test_model_flops_and_active_params_match(full_params):
    for arch in list_archs():
        n, _, jn, _ = full_params[arch]
        assert n == jn
        cfg, jcfg = get_config(arch), jget_config(arch)
        act = troof.active_params(cfg, n)
        assert act == jroof.active_params(jcfg, jn)
        for name, shape in INPUT_SHAPES.items():
            assert troof.model_flops(cfg, shape, act) == jroof.model_flops(
                jcfg, JSHAPES[name], act)


def test_parameter_bytes_on_meta_match_the_reference(full_params):
    for arch in list_archs():
        _, nbytes, _, jbytes = full_params[arch]
        assert nbytes == jbytes


@pytest.mark.parametrize("preset", ["tpu-v5e", "gpu", "cpu"])
def test_roofline_terms_match(preset):
    for flops, nbytes, coll in ((1e12, 1e9, 0.0), (197e12, 819e9, 50e9),
                                (3.1e15, 7.5e12, 1e6), (0.0, 1.0, 0.0)):
        a = troof.Roofline(flops, nbytes, coll, troof.PRESETS[preset])
        b = jroof.Roofline(flops, nbytes, coll, jroof.PRESETS[preset])
        assert (a.t_compute, a.t_memory, a.t_collective, a.t_bound,
                a.dominant) == (b.t_compute, b.t_memory, b.t_collective,
                                b.t_bound, b.dominant)
        ad, bd = a.as_dict(), b.as_dict()
        assert {k: ad[k] for k in bd} == bd


def test_h100_is_the_default():
    h = troof.PRESETS["h100"]
    assert (h.peak_flops, h.hbm_bw, h.ici_bw, h.ici_links, h.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 1, 80e9)
    assert troof.Roofline(1.0, 1.0, 0.0).hw is h
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.ICI_BW) == (
        989e12, 3.35e12, 450e9)
    assert troof.resolve_preset("h100") is h
    if not torch.cuda.is_available():
        assert troof.resolve_preset("auto") is troof.PRESETS["cpu"]
    with pytest.raises(KeyError):
        troof.resolve_preset("h200")


# --------------------------------------------------------- op counter

def _wx():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((8, 64, 64)).astype(np.float32),
            rng.standard_normal((4, 64)).astype(np.float32))


def test_dot_flops_match_loop_aware_totals_scan_and_unroll():
    W, x = _wx()
    Wj, xj = jnp.asarray(W), jnp.asarray(x)

    def scanned(x):
        return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x,
                            Wj)[0].sum()

    def unrolled(x):
        h = x
        for i in range(8):
            h = jnp.tanh(h @ Wj[i])
        return h.sum()

    want = [loop_aware_totals(jax.jit(f).lower(xj).compile().as_text())[
        "dot_flops"] for f in (scanned, unrolled)]
    Wt, h = torch.from_numpy(W), torch.from_numpy(x)
    with op_costs.OpCounter() as c:
        for i in range(8):
            h = torch.tanh(h @ Wt[i])
        h.sum()
    assert c.totals()["dot_flops"] == want[0] == want[1] == 8 * 2 * 4 * 64 * 64
    assert c.totals()["collective_bytes"] == 0.0
    assert c.totals()["op_histogram"]["mm"] == 8


def test_dot_flops_match_loop_aware_totals_nested():
    W, x = _wx()
    Wj = jnp.asarray(W)

    def nested(x):
        def outer(h, _):
            h, _ = jax.lax.scan(lambda h2, w: (jnp.tanh(h2 @ w), None), h,
                                Wj)
            return h, None
        return jax.lax.scan(outer, x, None, length=3)[0].sum()

    want = loop_aware_totals(jax.jit(nested).lower(jnp.asarray(x))
                             .compile().as_text())["dot_flops"]
    Wt, h = torch.from_numpy(W), torch.from_numpy(x)
    with op_costs.OpCounter() as c:
        for _ in range(3):
            for i in range(8):
                h = torch.tanh(h @ Wt[i])
    assert c.totals()["dot_flops"] == want == 3 * 8 * 2 * 4 * 64 * 64


def test_counter_decomposes_composites_and_follows_memory():
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 2)
    with torch.inference_mode(), op_costs.OpCounter() as c:
        torch.einsum("bij,bjk->bik", a, b)
        x = torch.empty(64, 1024)              # 256 KiB, freed at once
        del x
        y = torch.ones(32, 1024)               # 128 KiB, kept
    tot = c.totals()
    assert tot["aten_dot_flops"] == 2 * 3 * 5 * 2 * 7
    assert "einsum" not in tot["op_histogram"]
    assert c.peak_bytes >= 64 * 1024 * 4 and c.live_bytes >= 32 * 1024 * 4
    assert tot["traffic_bytes"] >= 2 * 32 * 1024 * 4
    del y


def test_kernels_record_their_work_once():
    """On the CPU the attention wrapper runs its plain version: the
    counter sees none of its aten ops, only the recorded cost."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 48, 4, 16))
                                .astype(np.float32)) for _ in range(3))
    with op_costs.OpCounter() as c:
        fa_ops.flash_attention(q, k, v, causal=True, window=20)
    tot = c.totals()
    flops, nbytes = fa_ops.forward_cost(q, k, True, 20)
    assert tot["kernels"] == {"flash_attention": {
        "calls": 1, "flops": flops, "bytes": nbytes}}
    assert tot["n_ops"] == 0 and tot["dot_flops"] == flops
    pairs = sum(min(i + 1, 48) - max(0, i - 19) for i in range(48))
    assert fa_ops.attention_pairs(48, 48, True, 20) == pairs
    assert flops == 4 * 2 * 4 * 16 * pairs
    # outside a counted region nothing is recorded and nothing is hidden
    assert not op_costs.LOGS and op_costs._hidden == 0


PREFILL = ["tinyllama-1.1b", "qwen2-moe-a2.7b", "gemma3-4b",
           "jamba-v0.1-52b", "xlstm-1.3b"]


@pytest.mark.parametrize("arch", PREFILL)
def test_prefill_dot_flops_match_the_compiled_reference(arch):
    jcfg = jget_config(arch).reduced(d_model=64)
    params, _ = jm.init_model(jax.random.PRNGKey(0), jcfg)
    B, S = 2, 64
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    hlo = jax.jit(lambda p, t: jm.prefill(p, jcfg, {"tokens": t})[0]).lower(
        params, jnp.asarray(toks)).compile().as_text()
    want = loop_aware_totals(hlo)["dot_flops"]
    model = bridge.model_from_jax(params, bridge.model_config_from(jcfg),
                                  device="cpu")
    with torch.inference_mode(), op_costs.OpCounter() as c:
        tm.prefill(model, {"tokens": torch.from_numpy(toks)})
    got = c.totals()
    cfg = model.cfg
    kinds = [cfg.layer_pattern[i % len(cfg.layer_pattern)]
             for i in range(cfg.num_layers)]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    # attention: XLA multiplies every pair, the kernel records the
    # pairs the mask leaves (the reduced windows are past S)
    n_attn = kinds.count("attn")
    attn_term = n_attn * 4 * B * H * hd * (
        S * S - fa_ops.attention_pairs(S, S, True, 0))
    # mLSTM: the kernel's whole tile against XLA's lower triangle
    L = S
    mh = cfg.ssm.num_heads if cfg.ssm else 0
    mdh = (cfg.ssm.expand * cfg.d_model) // mh if mh else 0
    mlstm_term = kinds.count("mlstm") * 4 * B * mh * mdh * (
        L * L - L * (L + 1) // 2)
    # mLSTM: at one chunk from a zero state the reference's q n is a dot
    # with a constant zero, which XLA folds away; the kernel computes it
    qn_term = kinds.count("mlstm") * 2 * B * mh * mdh * S
    assert got["kernels"]
    assert got["dot_flops"] == want - attn_term + mlstm_term + qn_term, (
        got["dot_flops"], want, attn_term, mlstm_term, qn_term)


def test_xlstm_prefill_on_meta_matches_the_compiled_reference():
    """The reduced xlstm's prefill at S 256 traced on meta, its sLSTM
    loop over 128 steps counted by trip count: its dot FLOPs equal the
    compiled reference's ``loop_aware_totals``, which weights the scan's
    while body by its trip count.  No attention layer; at S 256 both
    sides count the mLSTM's whole L x L tiles and the normaliser's q n
    (2 L dh a row and chunk of 64): the reference's chunks are scanned,
    so nothing folds away as at one chunk."""
    jcfg = jget_config("xlstm-1.3b").reduced(d_model=64)
    params, _ = jm.init_model(jax.random.PRNGKey(0), jcfg)
    B, S = 2, 256
    toks = np.zeros((B, S), np.int32)
    hlo = jax.jit(lambda p, t: jm.prefill(p, jcfg, {"tokens": t})[0]).lower(
        params, jnp.asarray(toks)).compile().as_text()
    want = loop_aware_totals(hlo)["dot_flops"]
    cfg = bridge.model_config_from(jcfg)
    model = tm.init_model(cfg, device="meta")
    with torch.inference_mode(), op_costs.OpCounter() as c:
        tm.prefill(model, {"tokens": torch.empty(B, S, dtype=torch.int32,
                                                 device="meta")})
    got = c.totals()
    assert got["loops"] == [{"name": "slstm.steps", "trip_count": 128,
                             "runs": 2, "traced_runs": 2,
                             "iterations_traced": 6}]
    kinds = [cfg.layer_pattern[i % len(cfg.layer_pattern)]
             for i in range(cfg.num_layers)]
    assert "attn" not in kinds
    assert got["kernels"]["mlstm_scan"]["calls"] == kinds.count("mlstm")
    assert got["dot_flops"] == want, (got["dot_flops"], want)


# ------------------------------------------------------------- dry run

@pytest.fixture
def reduced(monkeypatch):
    """run_one over the reduced configs (the dry run's logic at small
    size; applicability does not depend on width or depth)."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())


def test_run_one_statuses_match_applicable(reduced, tmp_path):
    for arch in list_archs():
        for name, shape in INPUT_SHAPES.items():
            small = InputShape(name, 32 if shape.kind != "decode" else 48,
                               2, shape.kind)
            rec = dryrun.run_one(arch, small, knobs=PerfKnobs(),
                                 out_dir=tmp_path)
            ok, reason = jspecs.applicable(jget_config(arch), JSHAPES[name])
            assert rec["status"] == ("OK" if ok else "SKIP"), rec.get("error")
            if not ok:
                assert rec["reason"] == reason
                continue
            cfg = get_config(arch).reduced()
            mem = rec["memory"]
            assert rec["total_params"] * 4 == mem["parameter_bytes"]
            assert cfg.dtype == "float32"
            assert mem["peak_bytes_per_device"] == (mem["argument_bytes"]
                                                    + mem["temp_bytes"])
            assert mem["fits_one_card"]
            assert rec["cost"]["dot_flops"] > 0
            assert rec["roofline"]["hw"] == "h100"
            assert rec["model_flops"] == troof.model_flops(
                cfg, small, rec["active_params"])
            if small.kind == "train":
                assert mem["optimizer_bytes"] == 2 * mem["parameter_bytes"]
    assert len(list(tmp_path.glob("*.json"))) == 40


def test_knobs_keep_what_one_card_means():
    knobs, dropped = dryrun.knobs_for("qwen2-vl-72b", "train_4k")
    assert (knobs.microbatch, knobs.unit_group, knobs.moment_dtype) == (
        8, 4, "float32")
    assert dropped == {"moment_dtype": "bfloat16"}
    knobs, dropped = dryrun.knobs_for("qwen15_05b", "decode_32k")
    assert knobs == PerfKnobs() and "rule_overrides" in dropped
    assert dryrun.knobs_for("tinyllama-1.1b", "prefill_32k") == (
        PerfKnobs(), {})


def test_cli_writes_one_record_without_a_card(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape",
                        "prefill_32k", "--out", str(tmp_path)]) == 0
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["tinyllama-1.1b_prefill_32k.json"]
    rec = json.loads(files[0].read_text())
    assert rec["status"] == "OK" and rec["memory"]["device_bytes"] == 80e9
    cfg = get_config("tinyllama-1.1b")
    model = tm.init_model(cfg, device="meta")
    assert rec["memory"]["parameter_bytes"] == sum(
        p.numel() * p.element_size() for p in model.parameters())
    assert rec["cost"]["kernels"]["flash_attention"]["calls"] == \
        cfg.num_layers
    assert "[OK  ] tinyllama-1.1b" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--mesh", "ring"])
    err = capsys.readouterr().err
    assert "invalid choice" in err and "multipod" in err


def test_meta_build_allocates_nothing():
    cfg = dataclasses.replace(get_config("grok-1-314b"), num_layers=2)
    model = tm.init_model(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
