"""The port's sanitizer (``repro_torch.kernels.sanitize``) against the
JAX package's (``repro.kernels.sanitize``).

Every case of the four forward wrappers and of the engine runs on the
CPU (the plain versions) with the switch on, on numpy inputs made from
a seed, and its outcome (pass, or the error and its text) is held to
the reference's condition functions evaluated by
``repro.kernels.sanitize.run_checks`` on the reference's plain outputs
(``kernels/*/ref.py``, ``_mlstm_cell_chunkwise``) in place of its
Pallas kernels, which jax 0.9.0 no longer interprets: the router's
``router_route_checks``, and the conditions the reference's cascade,
attention and mLSTM wrappers and its engine's ``_sanitize_batch``
write inline, in their order.  The texts must be equal; checkify adds
" (`check` failed)" to its own.  Also: the switch is off by default,
reads ``REPRO_SANITIZE`` on every call, skips under ``owned()``, and
leaves outputs bit-identical; the engine through ``run()`` decides the
same with the switch on, and refuses a token id past the vocab with the
JAX engine's text.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import sanitize as tsan
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.router_cascade import ops as rc_ops
from repro_torch.kernels.router_score import ops as rs_ops
from repro_torch.serving import Request as TRequest
from repro_torch.serving import TryageEngine as TEngine
from test_torch_engine import RC
from torch_serving_util import make_engines, make_weights, workload
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import sanitize as jsan  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.router_cascade.ref import \
    router_score_cascade_ref  # noqa: E402
from repro.kernels.router_score.ops import router_route_checks  # noqa: E402
from repro.kernels.router_score.ref import router_score_ref  # noqa: E402
from repro.models.ssm import _mlstm_cell_chunkwise  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import TryageEngine as JEngine  # noqa: E402

SUFFIX = " (`check` failed)"


@pytest.fixture
def switch(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    tsan.set_sanitize(True)
    yield
    tsan.set_sanitize(None)


def reference(check_fn, *arrays):
    """The reference's outcome: None, or its error text."""
    try:
        jsan.run_checks(check_fn, *(jnp.asarray(a) for a in arrays))
    except ValueError as e:
        assert str(e).endswith(SUFFIX)
        return str(e)[:-len(SUFFIX)]
    return None


def port(fn):
    """The port's outcome: None, or its error text (a SanitizeError)."""
    try:
        fn()
    except tsan.SanitizeError as e:
        return str(e)
    return None


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ router

def router_inputs(seed, B=8, d=16, hh=8, M=4, n_c=2):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    head = {"w1": f(d, hh, scale=0.3), "b1": f(hh, scale=0.1),
            "w2": f(hh, M, scale=0.3), "b2": f(M, scale=0.1)}
    unc = {k: f(*v.shape, scale=0.3) for k, v in head.items()}
    return {"emb": f(B, d), "head": head, "unc": unc,
            "cvals": np.abs(f(n_c, M)), "lam": np.abs(f(B, n_c)),
            "ladder": rng.permutation(M).astype(np.int32)}


ROUTER_CASES = ["clean", "nan_emb", "inf_lambda", "nan_weight",
                "choice_out_of_range"]


def spoil(x, case):
    x = {k: (dict(v) if isinstance(v, dict) else v) for k, v in x.items()}
    if case == "nan_emb":
        x["emb"] = x["emb"].copy()
        x["emb"][2, 3] = np.nan
    elif case == "inf_lambda":
        x["lam"] = x["lam"].copy()
        x["lam"][1, 0] = np.inf
    elif case == "nan_weight":
        x["head"]["w2"] = x["head"]["w2"].copy()
        x["head"]["w2"][0, 1] = np.nan
    return x


@pytest.mark.parametrize("case", ROUTER_CASES)
def test_router_score_checks_match_reference(switch, monkeypatch, case):
    x = spoil(router_inputs(1), case)
    h = x["head"]
    M = h["w2"].shape[1]
    pred, choice = router_score_ref(*(jnp.asarray(a) for a in (
        x["emb"], h["w1"], h["b1"], h["w2"], h["b2"], x["cvals"],
        x["lam"])))
    if case == "choice_out_of_range":   # a kernel that writes a bad index
        choice = choice.at[3].set(M)
        plain = rs_ops._router_score

        def bad(*args):
            p, c = plain(*args)
            c = c.clone()
            c[3] = M
            return p, c
        monkeypatch.setattr(rs_ops, "_router_score", bad)
    want = reference(
        lambda p, c, e, lm: router_route_checks(p, c, e, h, lm),
        pred, choice, x["emb"], x["lam"])
    got = port(lambda: rs_ops.router_score_fused(
        t(x["emb"]), *(t(h[k]) for k in ("w1", "b1", "w2", "b2")),
        t(x["cvals"]), t(x["lam"])))
    assert got == want
    assert (want is None) == (case == "clean")


def cascade_checks(M):
    """The reference's cascade wrapper's conditions
    (src/repro/kernels/router_cascade/ops.py:47-59)."""
    def checks(p, s, c, e):
        jsan.check_finite("router_cascade", "predicted losses", p)
        jsan.check_finite("router_cascade", "sigma", s)
        jsan.check_in_range("router_cascade", "expert choice", c, 0, M)
        jsan.check_in_range("router_cascade", "escalation target", e, 0, M)
    return checks


@pytest.mark.parametrize("case", ["clean", "nan_emb", "nan_unc_weight",
                                  "esc_out_of_range"])
def test_router_cascade_checks_match_reference(switch, monkeypatch, case):
    x = spoil(router_inputs(2), "nan_emb" if case == "nan_emb" else "clean")
    if case == "nan_unc_weight":
        x["unc"]["b2"] = x["unc"]["b2"].copy()
        x["unc"]["b2"][1] = np.nan
    h, u = x["head"], x["unc"]
    M = h["w2"].shape[1]
    names = ("w1", "b1", "w2", "b2")
    outs = router_score_cascade_ref(*(jnp.asarray(a) for a in (
        x["emb"], *(h[k] for k in names), *(u[k] for k in names),
        x["cvals"], x["lam"], x["ladder"])))
    pred, sigma, choice, esc = outs
    if case == "esc_out_of_range":
        esc = esc.at[0].set(-1)
        plain = rc_ops._router_cascade

        def bad(*args):
            p, s, c, e = plain(*args)
            e = e.clone()
            e[0] = -1
            return p, s, c, e
        monkeypatch.setattr(rc_ops, "_router_cascade", bad)
    want = reference(cascade_checks(M), pred, sigma, choice, esc)
    got = port(lambda: rc_ops.router_score_cascade_fused(
        t(x["emb"]), *(t(h[k]) for k in names), *(t(u[k]) for k in names),
        t(x["cvals"]), t(x["lam"]), t(x["ladder"])))
    assert got == want
    assert (want is None) == (case == "clean")


# --------------------------------------------------------- attention

def flash_checks(T):
    """The reference attention wrapper's conditions
    (src/repro/kernels/flash_attention/ops.py:46-55)."""
    def checks(q, k, v, w, out):
        jsan.check_finite("flash_attention", "input", q, k, v)
        jsan.check_in_range("flash_attention", "window", w, 0, T + 1)
        jsan.check_finite("flash_attention", "output", out)
    return checks


FLASH_CASES = {"clean": 0, "window_T": 64, "nan_q": 0, "inf_v": 0,
               "window_past_T": 65, "negative_window": -3}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_checks_match_reference(switch, case):
    rng = np.random.default_rng(3)
    B, S, H, hd = 2, 64, 2, 16
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    if case == "nan_q":
        q[1, 5, 0, 2] = np.nan
    if case == "inf_v":
        v[0, 9, 1, 1] = np.inf
    window = FLASH_CASES[case]
    bh = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, hd))
    out = attention_ref(bh(q), bh(k), bh(v), causal=True,
                        window=max(window, 0))
    out = np.asarray(out).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    want = reference(flash_checks(S), q, k, v, np.asarray(window), out)
    got = port(lambda: fa_ops.flash_attention(t(q), t(k), t(v), causal=True,
                                              window=window))
    assert got == want
    assert (want is None) == (case in ("clean", "window_T"))


# -------------------------------------------------------------- mLSTM

def mlstm_checks():
    """The reference mLSTM wrapper's conditions
    (src/repro/kernels/mlstm_scan/ops.py:37-49)."""
    R = jsan.MLSTM_M_RANGE

    def checks(q, k, v, ig, fg, m0, h, m1):
        jsan.check_finite("mlstm_scan", "input", q, k, v, ig, fg)
        jsan.check_in_range("mlstm_scan", "stabilizer state m", m0, -R, R)
        jsan.check_finite("mlstm_scan", "output", h)
        jsan.check_in_range("mlstm_scan", "new stabilizer state m", m1, -R,
                            R)
    return checks


MLSTM_CASES = ["clean", "nan_q", "nan_gate", "m0_90", "m0_minus_80",
               "new_m_past_range"]


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_checks_match_reference(switch, case):
    rng = np.random.default_rng(4)
    B, S, H, dh = 1, 64, 2, 16
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, ig, fg = f(B, S, H, dh), f(B, S, H, dh), f(B, S, H, dh), \
        f(B, S, H), f(B, S, H) + 3.0
    st = {"C": f(B, H, dh, dh) * 0.3, "n": f(B, H, dh) * 0.3, "m": f(B, H)}
    if case == "nan_q":
        q[0, 7, 1, 3] = np.nan
    if case == "nan_gate":
        fg[0, 11, 0] = np.nan
    if case == "m0_90":
        st["m"][0, 1] = 90.0
    if case == "m0_minus_80":          # the band's lower edge is inside
        st["m"][0, 0] = -80.0
    if case == "new_m_past_range":     # a large input gate moves m past 80
        ig[0, 40, 1] = 120.0
    h, new = _mlstm_cell_chunkwise(*(jnp.asarray(a) for a in (q, k, v, ig,
                                                              fg)),
                                   {n: jnp.asarray(a) for n, a in st.items()})
    want = reference(mlstm_checks(), q, k, v, ig, fg, st["m"], h, new["m"])
    got = port(lambda: ml_ops.mlstm_chunkwise(
        t(q), t(k), t(v), t(ig), t(fg), {n: t(a) for n, a in st.items()}))
    assert got == want
    assert (want is None) == (case in ("clean", "m0_minus_80"))


# ------------------------------------------------------------- engine

ENGINE_CASES = {"clean": (0, None, None), "token_vocab": (64, None, None),
                "token_negative": (-1, None, None),
                "nan_pred": (0, np.nan, None), "choice_M": (0, None, 3),
                "token_and_nan": (64, np.nan, None)}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_sanitize_batch_matches_reference(case):
    """``_sanitize_batch`` of both engines on the same padded batch
    (neither reads more of the engine than its router config)."""
    tok, bad_pred, bad_choice = ENGINE_CASES[case]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, RC.vocab_size, (4, 32)).astype(np.int32)
    toks[2, 3] = tok or toks[2, 3]
    pred = rng.standard_normal((4, RC.n_models)).astype(np.float32)
    choice = pred.argmin(1).astype(np.int32)
    if bad_pred is not None:
        pred[1, 0] = bad_pred
    if bad_choice is not None:
        choice[0] = bad_choice
    outcome = []
    for cls, arr in ((JEngine, jnp.asarray), (TEngine, t)):
        eng = types.SimpleNamespace(rc=RC)
        try:
            cls._sanitize_batch(eng, toks, arr(pred), arr(choice))
            outcome.append(None)
        except ValueError as e:
            outcome.append(str(e).removesuffix(SUFFIX))
    assert outcome[1] == outcome[0]
    assert (outcome[0] is None) == (case == "clean")


@pytest.fixture(scope="module")
def weights(tiny_library):
    return make_weights(tiny_library)


def test_engine_run_same_decisions_with_the_switch(tiny_library, weights,
                                                   monkeypatch):
    """The port's engine through ``run()`` with the switch on decides
    and scores exactly as with it off (the checks only read), and as the
    JAX engine with its switch on."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    work = workload(n=96, cascade=True)
    results = []
    for on in (False, True):
        tsan.set_sanitize(on)
        jsan.set_sanitize(on)
        try:
            jeng, teng = make_engines(tiny_library, weights,
                                      fused_cascade=True)
            for w in work:
                teng.submit(TRequest(**w))
                jeng.submit(JRequest(**w))
            results.append(({r.uid: r for r in teng.run()},
                            {r.uid: r for r in jeng.run()}))
        finally:
            tsan.set_sanitize(None)
            jsan.set_sanitize(None)
    (off, _), (on, jon) = results
    for uid, r in on.items():
        assert (r.expert, r.cascade_depth) == (off[uid].expert,
                                               off[uid].cascade_depth)
        assert r.loss == off[uid].loss
        assert (r.expert, r.cascade_depth) == (jon[uid].expert,
                                               jon[uid].cascade_depth)


def test_engine_run_refuses_a_token_past_the_vocab(tiny_library, weights,
                                                   monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    w = workload(n=4)
    w[1] = dict(w[1], tokens=w[1]["tokens"].copy())
    w[1]["tokens"][5] = RC.vocab_size
    texts = []
    tsan.set_sanitize(True)
    jsan.set_sanitize(True)
    try:
        for eng, req in zip(make_engines(tiny_library, weights),
                            (JRequest, TRequest)):
            for x in w:
                eng.submit(req(**x))
            with pytest.raises(ValueError) as err:
                eng.run()
            texts.append(str(err.value))
    finally:
        tsan.set_sanitize(None)
        jsan.set_sanitize(None)
    assert texts[1] == texts[0] == (f"router_score: token id out of range "
                                    f"[0, {RC.vocab_size})")


# ------------------------------------------------------------- switch

def test_switch_off_by_default_and_read_from_env(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    tsan.set_sanitize(None)
    assert not tsan.sanitize_enabled()
    for value, on in (("1", True), ("true", True), (" ON ", True),
                      ("yes", True), ("0", False), ("", False),
                      ("off", False)):
        monkeypatch.setenv("REPRO_SANITIZE", value)
        assert tsan.sanitize_enabled() == on == jsan.sanitize_enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    tsan.set_sanitize(False)
    try:
        assert not tsan.sanitize_enabled()
    finally:
        tsan.set_sanitize(None)
    assert tsan.sanitize_enabled()


def test_env_switch_turns_the_wrapper_checks_on(monkeypatch):
    x = spoil(router_inputs(6), "nan_emb")
    h = x["head"]
    call = lambda: rs_ops.router_score_fused(
        t(x["emb"]), *(t(h[k]) for k in ("w1", "b1", "w2", "b2")),
        t(x["cvals"]), t(x["lam"]))
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    call()                                   # off: NaN passes through
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with pytest.raises(tsan.SanitizeError,
                       match="router_score: non-finite input"):
        call()


def test_checks_skip_under_owned(switch):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 32, 1, 8)).astype(np.float32)
    q[0, 0, 0, 0] = np.nan
    call = lambda: fa_ops.flash_attention(t(q), t(q), t(q), causal=True)
    with tsan.owned():
        with tsan.owned():
            call()
        call()
    with pytest.raises(tsan.SanitizeError):
        call()


def test_outputs_identical_with_the_switch_on(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    x = router_inputs(8)
    h, u = x["head"], x["unc"]
    names = ("w1", "b1", "w2", "b2")
    rng = np.random.default_rng(8)
    a = [t(rng.standard_normal((2, 48, 2, 16)).astype(np.float32))
         for _ in range(3)]
    g = [t(rng.standard_normal((2, 48, 2)).astype(np.float32))
         for _ in range(2)]
    st = {"C": torch.zeros(2, 2, 16, 16), "n": torch.zeros(2, 2, 16),
          "m": torch.zeros(2, 2)}
    calls = [
        lambda: rs_ops.router_score_fused(
            t(x["emb"]), *(t(h[k]) for k in names), t(x["cvals"]),
            t(x["lam"])),
        lambda: rc_ops.router_score_cascade_fused(
            t(x["emb"]), *(t(h[k]) for k in names),
            *(t(u[k]) for k in names), t(x["cvals"]), t(x["lam"]),
            t(x["ladder"])),
        lambda: (fa_ops.flash_attention(*a, causal=False, window=7),),
        lambda: ml_ops.mlstm_chunkwise(*a, *g, st)]

    def flat(out):
        return [y for o in out
                for y in (o.values() if isinstance(o, dict) else [o])]

    for call in calls:
        tsan.set_sanitize(False)
        off = flat(call())
        tsan.set_sanitize(True)
        try:
            on = flat(call())
        finally:
            tsan.set_sanitize(None)
        assert all(torch.equal(p, q) for p, q in zip(off, on))


def test_run_checks_raises_the_first_failed_check():
    bad = torch.tensor([0.0, float("nan")])
    with pytest.raises(tsan.SanitizeError, match="^k: non-finite a$"):
        tsan.run_checks(tsan.check_in_range("k", "r", 3, 0, 4),
                        tsan.check_finite("k", "a", bad),
                        tsan.check_in_range("k", "r", 5, 0, 4))
    tsan.run_checks(tsan.check_finite("k", "a", torch.ones(3)),
                    tsan.check_in_range("k", "r", torch.arange(4), 0, 4))
    assert issubclass(tsan.SanitizeError, ValueError)
    assert tsan.MLSTM_M_RANGE == jsan.MLSTM_M_RANGE
