"""Fused Tryage routing head: the CUDA kernel's wrapper, its plain
version, and the public ``router_head`` / ``router_route``.

``router_score_fused`` computes, in one launch on a CUDA tensor
(``csrc/router_score.cu``, which replaces the Pallas ``_router_kernel``
of ``src/repro/kernels/router_score/kernel.py`` — see the source for the
design and what bounds it)::

    pred   = softplus(gelu_tanh(emb @ w1 + b1) @ w2 + b2)   (B, M) f32
    choice = argmin(pred + lam @ cvals)                      (B,) int32

with ties going to the first index.  On a CPU tensor it runs
``router_score_plain``.  Rows are independent: one cluster of blocks
per row.

Bound on the H100: bytes (~90 KB of weights and rows at B=32, about
27 ns at 3.35 TB/s), far below the launch floor, the device time of an
empty kernel (``csrc/launch_floor.cu``; ``chip_smoke.py`` times both).
What the design has to beat is the weights' trip from L2, which one SM
makes at a low rate: each row's hidden units are split over a cluster
of 8 blocks on 8 SMs, each reading an eighth of w1, whose shares of the
second layer meet in the first block's shared memory (distributed
shared memory); every intermediate stays on chip.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build

CLUSTER = 8     # blocks a row takes (kCluster in csrc/router_head.cuh)
THREADS = 256   # most threads a block takes (kRouterMaxThreads there)


def decision_plan(B: int, d: int, hh: int, heads: int = 1) -> dict:
    """The launch geometry of a router kernel over ``B`` rows of width
    ``d`` with ``heads`` hidden layers of ``hh`` units (2 for the
    cascade): a cluster of ``CLUSTER`` blocks per row, each block a
    slice of ``units_per_block`` hidden units of every head, its threads
    owning (k-group, hidden unit) pairs, with as many k-groups (a power
    of two, at most ``d``) as fit ``THREADS``.  The wrappers launch
    exactly this geometry."""
    per_block = -(-hh // CLUSTER)
    units = heads * per_block
    groups = 1
    while 2 * groups * units <= THREADS and 2 * groups <= d:
        groups *= 2
    threads = min(THREADS, -(-groups * units // 32) * 32)
    return {"grid": CLUSTER * B, "cluster": CLUSTER,
            "units_per_block": per_block, "threads": threads,
            "k_groups": groups}


def softplus(x):
    """``jax.nn.softplus`` (logaddexp(x, 0)) without torch's threshold."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def head_plain(emb, w1, b1, w2, b2):
    h = F.gelu(emb.float() @ w1 + b1, approximate="tanh")
    return softplus(h @ w2 + b2)


def router_score_plain(emb, w1, b1, w2, b2, cvals, lam):
    """The plain PyTorch version of the kernel."""
    pred = head_plain(emb, w1, b1, w2, b2)
    combined = pred + lam.float() @ cvals
    return pred, torch.argmin(combined, dim=1).to(torch.int32)


def check_head(name, emb, w1, b1, w2, b2, cvals, lam):
    """Shapes, types and devices shared by both router kernels."""
    B, d = emb.shape
    hh, M = w2.shape
    tensors = {"emb": emb, "w1": w1, "b1": b1, "w2": w2, "b2": b2,
               "cvals": cvals, "lam": lam}
    want = {"w1": (d, hh), "b1": (hh,), "b2": (M,),
            "cvals": (cvals.shape[0], M), "lam": (B, cvals.shape[0])}
    for key, shape in want.items():
        if tuple(tensors[key].shape) != shape:
            raise ValueError(f"{name}: {key} has shape "
                             f"{tuple(tensors[key].shape)}, want {shape}")
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != emb.device:
            raise ValueError(f"{name}: {key} on {t.device}, emb on "
                             f"{emb.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if emb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {emb.device}")


def router_score_fused(emb, w1, b1, w2, b2, cvals, lam):
    """emb (B, d); w1 (d, hh); b1 (hh,); w2 (hh, M); b2 (M,);
    cvals (n_c, M); lam (B, n_c), all float32 on one device.
    Returns (pred (B, M) f32, choice (B,) int32)."""
    check_head("router_score", emb, w1, b1, w2, b2, cvals, lam)
    if emb.device.type == "cpu":
        return router_score_plain(emb, w1, b1, w2, b2, cvals, lam)
    build.refuse_grad("router_score", emb, w1, b1, w2, b2, cvals, lam)
    B, d = emb.shape
    hh, M = w2.shape
    plan = decision_plan(B, d, hh)
    pred = torch.empty(B, M, dtype=torch.float32, device=emb.device)
    choice = torch.empty(B, dtype=torch.int32, device=emb.device)
    build.launch(
        "tryage_router_score", emb.device, emb.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), cvals.data_ptr(),
        lam.data_ptr(), pred.data_ptr(), choice.data_ptr(), B, d, hh, M,
        cvals.shape[0], plan["threads"], plan["k_groups"])
    router_score_fused.launches += 1
    return pred, choice


router_score_fused.launches = 0


def as_f32(x, device) -> torch.Tensor:
    """Host arrays (numpy) or tensors as contiguous float32 on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()


def router_head(emb, head_params):
    """Predicted losses only (no constraints)."""
    M = head_params["w2"].shape[1]
    cvals = torch.zeros(1, M, dtype=torch.float32, device=emb.device)
    lam = torch.zeros(emb.shape[0], 1, dtype=torch.float32, device=emb.device)
    pred, _ = router_score_fused(emb, head_params["w1"], head_params["b1"],
                                 head_params["w2"], head_params["b2"],
                                 cvals, lam)
    return pred


def router_route(emb, head_params, constraints, lambdas):
    """Full fused decision: MLP head -> softplus -> per-request
    lambda-weighted constraint add -> argmin, in one kernel launch.

    constraints: (n_c, M); lambdas: (B, n_c), numpy or tensors.
    Returns (pred_losses (B, M) f32, choice (B,) int32) on emb's device.
    """
    return router_score_fused(
        emb, head_params["w1"], head_params["b1"], head_params["w2"],
        head_params["b2"], as_f32(constraints, emb.device),
        as_f32(lambdas, emb.device))
