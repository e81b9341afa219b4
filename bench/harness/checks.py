"""The numbers that decide ``correct``, computed against the plain
references after the window.

Served library (``tryage``): for each sampled Result, against the
reference over the same request,
  ``pred_err``  the largest gap of a predicted loss (all experts),
  ``nll_err``   the largest gap of the served expert's masked NLL,
  ``token_gap`` the widest gap by which a predicted token's logit lies
                below the reference's best at that position.
The NLL and the logits are the reference's for the expert the reference
picks, or for the program's pick where the two are within ``TIE`` of
each other in the reference's constrained score (either is then right);
a wrong pick therefore shows in ``nll_err`` and ``token_gap``.

Served language model (``lm``): in decode, ``mean_token_gap``, the mean
over the served tokens of the gap by which a token's logit lies below
the reference's best, each against the reference's full forward pass
over the prompt and the tokens served before it (the widest such gap
does not separate bfloat16 from its fp8 control: PERF.md); in prefill,
which serves one token a request, ``logit_err``, the largest gap of a
last-position logit (a served token's gap is at most twice it).

A control runs the reference at a lower precision in the program's
place: its answers are what that precision picks (``*_outputs``).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.precision import Products, no_tf32

TIE = 1e-5          # constrained-score gap under which two picks tie
# the control of each served type: the precision just below it
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
ROUTER_ROWS = 64    # reference rows a pass, so that it fits beside others
EXPERT_ROWS = 32


def _requests(traffic, uids, device, constraints):
    reqs = [traffic.request(u) for u in uids]
    toks = torch.from_numpy(np.stack([r[0] for r in reqs])).to(device)
    targets = torch.from_numpy(np.stack([r[1] for r in reqs])).to(device)
    mask = torch.from_numpy(np.stack([r[2] for r in reqs])).to(device)
    lam = np.array([[r[3].get(c, 0.0) for c in constraints] for r in reqs],
                   np.float64)
    return toks, targets, mask, lam


def _predict(ref, cfg, weights, toks, P):
    return torch.cat([ref.predict(weights, cfg, toks[i:i + ROUTER_ROWS], P)
                      for i in range(0, len(toks), ROUTER_ROWS)]).cpu().numpy()


def _expert(ref, cfg, weights, name, toks, targets, mask, P, reduce):
    """(nll array, reduced array) of expert ``name`` over the rows given,
    ``EXPERT_ROWS`` at a time: ``reduce(logits, rows)`` turns a block's
    logits (its rows of ``toks``, a slice) into a row each, so that no
    more than a block's logits are held."""
    out, nll = [], []
    for i in range(0, len(toks), EXPERT_ROWS):
        sl = slice(i, i + EXPERT_ROWS)
        lg, nl = ref.expert_eval(weights, cfg, name, toks[sl], targets[sl],
                                 mask[sl], P)
        out.append(reduce(lg, sl))
        nll.append(nl.cpu().numpy())
        del lg
    return np.concatenate(nll), np.concatenate(out)


def tryage_outputs(ref, cfg, weights, traffic, uids, device, mode):
    """The answers of the reference at precision ``mode`` in the
    program's place: uid -> (expert, pred, nll, predictions)."""
    no_tf32()
    P = Products(mode)
    names = [e["name"] for e in cfg["experts"]]
    toks, targets, mask, lam = _requests(traffic, uids, device,
                                         cfg["constraints"])
    pred = _predict(ref, cfg, weights, toks, P)
    choice = ref.scores(cfg, pred, lam).argmin(1)
    out = {}
    for e in sorted(set(choice.tolist())):
        rows = np.flatnonzero(choice == e)
        idx = torch.from_numpy(rows).to(device)
        nll, preds = _expert(ref, cfg, weights, names[e], toks[idx],
                             targets[idx], mask[idx], P,
                             lambda lg, sl: lg.argmax(-1).cpu().numpy())
        for j, r in enumerate(rows):
            out[uids[r]] = (names[e], pred[r], float(nll[j]), preds[j])
    return out


def tryage_numbers(ref, cfg, weights, traffic, uids, outputs, device):
    """``pred_err``, ``nll_err`` and ``token_gap`` of ``outputs`` (uid ->
    (expert, pred, nll, predictions)) over ``uids``."""
    no_tf32()
    P = Products("f32")
    names = [e["name"] for e in cfg["experts"]]
    toks, targets, mask, lam = _requests(traffic, uids, device,
                                         cfg["constraints"])
    pred = _predict(ref, cfg, weights, toks, P)
    scores = ref.scores(cfg, pred, lam)
    best = scores.argmin(1)
    picked = np.array([names.index(outputs[u][0]) for u in uids])
    rows_ = np.arange(len(uids))
    tie = scores[rows_, picked] - scores[rows_, best] <= TIE
    judge = np.where(tie, picked, best)
    prog_pred = np.stack([outputs[u][1] for u in uids]).astype(np.float64)
    nll_gaps, token_gaps = [], []
    for e in sorted(set(judge.tolist())):
        rows = np.flatnonzero(judge == e)
        idx = torch.from_numpy(rows).to(device)
        served = torch.from_numpy(np.stack(
            [outputs[uids[r]][3] for r in rows])).to(device).long()
        nll, gaps = _expert(ref, cfg, weights, names[e], toks[idx],
                            targets[idx], mask[idx], P,
                            lambda lg, sl: _gaps(lg, served[sl]))
        masked = mask[idx].sum(-1).cpu().numpy() > 0
        # an answer without masked positions has no loss; one with them
        # must have it
        loss = np.array([np.nan if outputs[uids[r]][2] is None
                         else outputs[uids[r]][2] for r in rows], np.float64)
        nll_gaps.append(np.where(masked, np.abs(loss - nll),
                                 np.where(np.isnan(loss), 0.0, np.inf)))
        token_gaps.append(gaps)
    return {"pred_err": worst(np.abs(prog_pred - pred)),
            "nll_err": worst(np.concatenate(nll_gaps)),
            "token_gap": worst(np.concatenate(token_gaps))}


def worst(values) -> float:
    """The largest of ``values``; infinite where any is not a number, so
    that a NaN answer can never pass."""
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return 0.0
    if np.isnan(values).any():
        return float("inf")
    return float(values.max())


def _gaps(logits, tokens) -> np.ndarray:
    """Widest gap of ``tokens``' logits below the best, a row each:
    logits (B, S, V), tokens (B, S); infinite for a token outside the
    vocabulary (one that another expert's head would give)."""
    V = logits.shape[-1]
    got = logits.gather(-1, tokens.clamp(0, V - 1)[..., None])[..., 0]
    gaps = (logits.max(-1).values - got).masked_fill(
        (tokens < 0) | (tokens >= V), float("inf"))
    return np.array([worst(r) for r in gaps.cpu().numpy()])


def lm_reference_logits(ref, cfg, weights, seqs, positions, device, mode):
    """Logits (N, len(positions), V) of the reference at ``mode`` over
    the sequences (N, L)."""
    no_tf32()
    toks = torch.from_numpy(np.asarray(seqs)).to(device)
    return ref.logits_at(weights, cfg, toks, positions, Products(mode))


def lm_numbers(ref, cfg, weights, seqs, positions, served, device,
               control=None) -> dict:
    """``mean_token_gap`` of the tokens ``served`` (N, len(positions)) at
    the ``positions`` of the sequences ``seqs`` (N, L).  With
    ``control`` the reference at that precision answers in the
    program's place: its top token at each position."""
    want = lm_reference_logits(ref, cfg, weights, seqs, positions, device,
                               "f32")
    if control is not None:
        served = lm_reference_logits(ref, cfg, weights, seqs, positions,
                                     device, control).argmax(-1)
    served = torch.as_tensor(served).to(want.device).long()
    got = want.gather(-1, served[..., None])[..., 0]
    gaps = (want.max(-1).values - got).cpu().numpy()
    return {"mean_token_gap": float(gaps.mean()) if np.isfinite(gaps).all()
            else float("inf")}


def lm_logit_numbers(ref, cfg, weights, seqs, last_logits, device,
                     control=None) -> dict:
    """``logit_err``: the largest gap between the logits ``last_logits``
    (N, V) and the reference's at the last position of ``seqs`` (N, L);
    with ``control`` the reference at that precision gives them."""
    L = np.asarray(seqs).shape[1]
    want = lm_reference_logits(ref, cfg, weights, seqs, [L - 1], device,
                               "f32")[:, 0]
    if control is not None:
        got = lm_reference_logits(ref, cfg, weights, seqs, [L - 1], device,
                                  control)[:, 0]
    else:
        got = torch.as_tensor(last_logits).to(want.device).float()
    return {"logit_err": worst((got - want).abs().cpu().numpy())}
