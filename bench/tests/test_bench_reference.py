"""Each plain reference against the port's own path, on the CPU at tiny
widths, in float32: the router's predictions and decision, the
experts' logits and NLL, and a language model's prefill and decode
through the KV cache (a window that the decode wraps)."""

import copy

import numpy as np
import pytest
import torch

import tiny
from harness.weights import derive, make
from reference.precision import Products

F32 = Products("f32")


@pytest.fixture(scope="module")
def library():
    c = tiny.cell("bert11-backlog-s512")
    w = make(c.ref.param_specs(c.cfg), [(derive(3, "w"), 1.0)], "cpu",
             torch.float32)
    built = c.adapter.build(c.cfg, c.ref, w, "cpu")
    toks = torch.randint(1, c.cfg["vocab_size"], (5, 24),
                         generator=torch.Generator().manual_seed(0))
    return c, w, built, toks


def test_router_predictions_and_decisions(library):
    from repro_torch.core.router import router_embed
    from repro_torch.kernels.router_score.ops import router_route
    c, w, built, toks = library
    router = built["router"]
    emb = router_embed(router, router.rc, {"tokens": toks})
    cmat = c.ref.constraint_matrix(c.cfg)
    lam = np.array([[0, 0], [1, 0], [8, 0], [0, 2], [0.5, 0.5]], np.float32)
    with torch.no_grad():
        pred, choice = router_route(emb, router.head,
                                    torch.from_numpy(cmat).float(),
                                    torch.from_numpy(lam))
    want = c.ref.predict(w, c.cfg, toks, F32)
    torch.testing.assert_close(pred, want, rtol=1e-5, atol=1e-5)
    scores = c.ref.scores(c.cfg, want.numpy(), lam.astype(np.float64))
    np.testing.assert_array_equal(choice.numpy(), scores.argmin(1))


def test_constraints_match_the_engine(library):
    c, _, built, _ = library
    eng = built["engine"]
    np.testing.assert_allclose(eng._cmat, c.ref.constraint_matrix(c.cfg),
                               rtol=1e-6)


def test_expert_logits_and_nll(library):
    from repro_torch.serving.engine import TryageEngine
    c, w, built, toks = library
    targets = torch.randint(4, c.cfg["vocab_size"], toks.shape,
                            generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(24) % 3 == 1).int().expand(5, 24)
    for e in built["library"].experts:
        logits, nll = c.ref.expert_eval(w, c.cfg, e.name, toks, targets,
                                        mask, F32)
        with torch.no_grad():
            preds, loss, _ = TryageEngine._expert_forward(e.params, toks,
                                                          targets, mask)
        np.testing.assert_allclose(loss.numpy(), nll.numpy(), rtol=1e-5)
        np.testing.assert_array_equal(preds.numpy(),
                                      logits.argmax(-1).numpy())


@pytest.fixture(scope="module")
def lm():
    c = tiny.cell("sc2-decode-b32")
    c.cfg = dict(copy.deepcopy(c.cfg), dtype="float32", sliding_window=8)
    w = make(c.ref.param_specs(c.cfg), [(derive(5, "w"), 1.0)], "cpu",
             torch.float32)
    model = c.adapter.build(c.cfg, c.ref, w, "cpu")["model"]
    return c, w, model


def test_lm_prefill_logits(lm):
    c, w, model = lm
    toks = torch.randint(0, c.cfg["vocab_size"], (2, 12),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model(toks, mode="train")
    want = c.ref.logits_at(w, c.cfg, toks, range(12), F32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_lm_decode_through_the_cache(lm):
    from repro_torch.launch.steps import prefill_step
    from repro_torch.models.model import decode_step
    c, w, model = lm
    S, K = 6, 9          # 15 positions over a window of 8: the ring wraps
    toks = torch.randint(0, c.cfg["vocab_size"], (2, S + K),
                         generator=torch.Generator().manual_seed(3))
    want = c.ref.logits_at(w, c.cfg, toks, range(S - 1, S + K), F32)
    last, state = prefill_step(model, {"tokens": toks[:, :S]},
                               cache_capacity=S + K, device="cpu")
    got = [last]
    with torch.inference_mode():
        for k in range(K):
            logits, state = decode_step(model, {"tokens": toks[:, S + k:S + k + 1]},
                                        state, S + k)
            got.append(logits.float())
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=1e-4,
                               atol=1e-4)


def test_loss_table_by_hand(library):
    from harness.corpus import DOMAINS
    from harness.systems.tryage import loss_table
    c = library[0]
    t = loss_table(c.cfg, c.ref)
    fit = c.cfg["router_fit"]
    n_mid = c.ref.n_params(c.cfg, c.cfg["experts"][1])
    # "mid" focuses on github and dm_math: 0.2 / 8 + 0.8 / 2 on each
    want = (fit["loss_base"] - fit["loss_per_log_param"] * np.log(n_mid / 1e6)
            - fit["loss_per_focus"] * (0.2 / 8 + 0.4))
    assert t[DOMAINS.index("github"), 1] == pytest.approx(want)
    assert t[DOMAINS.index("pubmed"), 1] == pytest.approx(
        want + fit["loss_per_focus"] * 0.4)
    # no focus: an eighth on every domain
    assert np.ptp(t[:, 0]) == 0


def test_router_fit_is_seeded_and_centred(library):
    from harness.systems.tryage import fit_router_head, loss_table
    c, w, _, _ = library
    pool = np.random.default_rng(0).integers(4, c.cfg["vocab_size"], (40, 24))
    domains = np.arange(40) % 8
    heads = []
    for _ in range(2):
        ww = {k: v.clone() for k, v in w.items()}
        share = fit_router_head(c.cfg, c.ref, ww, torch.from_numpy(pool),
                                domains)
        assert 0.0 <= share <= 1.0
        heads.append(ww)
    for k in ("router.head.w2", "router.head.b2"):
        torch.testing.assert_close(heads[0][k], heads[1][k], rtol=0, atol=0)
        assert not torch.equal(heads[0][k], w[k])
    # the intercept is fit: the predictions' mean before the softplus is
    # the table's
    pred = c.ref.predict(heads[0], c.cfg, torch.from_numpy(pool), F32)
    z_hat = torch.log(torch.expm1(pred.double()))
    want = torch.from_numpy(loss_table(c.cfg, c.ref)[domains])
    z = want + torch.log(-torch.expm1(-want))
    assert abs(float((z_hat - z).mean())) < 1e-2
