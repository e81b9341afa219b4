"""One-launch cascade decision: the CUDA kernel's wrapper, its plain
version and the public ``router_route_cascade``.

On a CUDA tensor ``router_score_cascade_fused`` launches
``csrc/router_cascade.cu`` (which replaces the Pallas
``_cascade_kernel`` of ``src/repro/kernels/router_cascade/kernel.py`` —
see the source for the design and what bounds it); on a CPU tensor it
runs ``router_cascade_plain``.  Outputs: the loss head's predictions,
the uncertainty head's sigma (softplus + ``UNC_FLOOR``), the
constrained first pick, and the router-preferred depth-1 escalation
target — the constrained argmin over the experts strictly above the
pick on the escalation ladder, ties to the earliest rung, echoing the
pick at the top rung (``core.objective.cascade_choice``'s step).

Bound on the H100: bytes (~160 KB for both heads at B=32, about 49 ns),
far below the launch floor, as for ``router_score``, whose kernel body
this one shares: a cluster of blocks per row, each block with both
heads' slices of hidden units side by side, so the second head widens
each block's work instead of adding a pass; the escalation target is
one more shuffle reduction after the argmin.
"""

from __future__ import annotations

import torch

from repro_torch.core.router import UNC_FLOOR
from repro_torch.kernels import build, sanitize
from repro_torch.kernels.router_score.ops import as_f32, check_head
from repro_torch.kernels.router_score.ops import decision_plan as score_plan
from repro_torch.kernels.router_score.ops import head_cost, head_plain
from repro_torch.launch import op_costs


def decision_plan(B: int, d: int, hh: int,
                  k_groups: int | None = None) -> dict:
    """The launch geometry of a ``router_route_cascade`` call: the
    router kernels' plan with both heads' hidden units in each block
    (``k_groups`` unset: the table's ``router_cascade`` entry, else the
    default)."""
    return score_plan(B, d, hh, heads=2, k_groups=k_groups,
                      kernel="router_cascade")


def router_cascade_plain(emb, w1, b1, w2, b2, uw1, ub1, uw2, ub2, cvals,
                         lam, ladder_pos):
    """The plain PyTorch version of the kernel."""
    pred = head_plain(emb, w1, b1, w2, b2)
    sigma = head_plain(emb, uw1, ub1, uw2, ub2) + UNC_FLOOR
    combined = pred + lam.float() @ cvals
    choice = torch.argmin(combined, dim=1)
    pos = ladder_pos.long()
    M = combined.shape[1]
    above = pos[None, :] > pos[choice][:, None]                  # (B, M)
    masked = torch.where(above, combined, torch.full_like(combined,
                                                          float("inf")))
    minval = masked.min(dim=1, keepdim=True).values
    cand_pos = torch.where(masked == minval, pos[None, :],
                           torch.full_like(masked, M, dtype=torch.long))
    best_pos = cand_pos.min(dim=1).values
    ids = torch.arange(M, device=emb.device)[None, :]
    esc = torch.where(pos[None, :] == best_pos[:, None], ids, 0).sum(dim=1)
    esc = torch.where(above.any(dim=1), esc, choice)
    return pred, sigma, choice.to(torch.int32), esc.to(torch.int32)


def router_score_cascade_fused(emb, w1, b1, w2, b2, uw1, ub1, uw2, ub2,
                               cvals, lam, ladder_pos, *, k_groups=None):
    """emb (B, d); loss head w1/b1/w2/b2 and uncertainty head
    uw1/ub1/uw2/ub2 (same shapes); cvals (n_c, M); lam (B, n_c);
    ladder_pos (M,) int32, each expert's rung on the escalation ladder.
    Returns (pred, sigma (B, M) f32, choice, esc (B,) int32).
    ``k_groups``: the launch geometry (``decision_plan``).  Under the
    sanitizer the outputs are checked after the call."""
    name = "router_cascade"
    check_head(name, emb, w1, b1, w2, b2, cvals, lam)
    check_head(name, emb, uw1, ub1, uw2, ub2, cvals, lam)
    if uw2.shape != w2.shape:
        raise ValueError(f"{name}: heads differ: {tuple(w2.shape)} vs "
                         f"{tuple(uw2.shape)}")
    M = w2.shape[1]
    if (ladder_pos.shape != (M,) or ladder_pos.dtype != torch.int32
            or ladder_pos.device != emb.device):
        raise ValueError(f"{name}: ladder_pos must be int32 ({M},) on "
                         f"{emb.device}")
    B, d = emb.shape
    hh = w2.shape[0]
    out = op_costs.kernel_call(
        name, lambda: head_cost(B, d, hh, M, cvals.shape[0], True),
        _router_cascade, emb, w1, b1, w2, b2, uw1, ub1, uw2, ub2, cvals, lam,
        ladder_pos, k_groups)
    if sanitize.wrapper_checks():
        pred, sigma, choice, esc = out
        sanitize.run_checks(
            sanitize.check_finite(name, "predicted losses", pred),
            sanitize.check_finite(name, "sigma", sigma),
            sanitize.check_in_range(name, "expert choice", choice, 0, M),
            sanitize.check_in_range(name, "escalation target", esc, 0, M))
    return out


def _router_cascade(emb, w1, b1, w2, b2, uw1, ub1, uw2, ub2, cvals, lam,
                    ladder_pos, k_groups):
    B, d = emb.shape
    hh, M = w2.shape
    dev = emb.device
    if dev.type == "meta":
        return (torch.empty(B, M, device=dev), torch.empty(B, M, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev))
    if dev.type == "cpu":
        return router_cascade_plain(emb, w1, b1, w2, b2, uw1, ub1, uw2, ub2,
                                    cvals, lam, ladder_pos)
    build.refuse_grad("router_cascade", emb, w1, b1, w2, b2, uw1, ub1, uw2,
                      ub2, cvals, lam)
    plan = decision_plan(B, d, hh, k_groups=k_groups)
    pred = torch.empty(B, M, dtype=torch.float32, device=dev)
    sigma = torch.empty(B, M, dtype=torch.float32, device=dev)
    choice = torch.empty(B, dtype=torch.int32, device=dev)
    esc = torch.empty(B, dtype=torch.int32, device=dev)
    build.launch(
        "tryage_router_cascade", dev, emb.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), uw1.data_ptr(),
        ub1.data_ptr(), uw2.data_ptr(), ub2.data_ptr(), cvals.data_ptr(),
        lam.data_ptr(), ladder_pos.data_ptr(), pred.data_ptr(),
        sigma.data_ptr(), choice.data_ptr(), esc.data_ptr(), B, d, hh, M,
        cvals.shape[0], plan["threads"], plan["k_groups"])
    router_score_cascade_fused.launches += 1
    return pred, sigma, choice, esc


router_score_cascade_fused.launches = 0


def router_route_cascade(emb, head_params, unc_params, constraints, lambdas,
                         ladder_pos):
    """Full fused cascade decision in one kernel launch.

    constraints: (n_c, M); lambdas: (B, n_c); ladder_pos: (M,) int —
    numpy or tensors.  Returns ``(pred (B, M) f32, sigma (B, M) f32,
    choice (B,) int32, esc (B,) int32)`` on emb's device."""
    dev = emb.device
    pos = torch.as_tensor(ladder_pos).to(device=dev, dtype=torch.int32)
    return router_score_cascade_fused(
        emb, head_params["w1"], head_params["b1"], head_params["w2"],
        head_params["b2"], unc_params["w1"], unc_params["b1"],
        unc_params["w2"], unc_params["b2"], as_f32(constraints, dev),
        as_f32(lambdas, dev), pos.contiguous())
