"""Chunkwise mLSTM scan: the CUDA kernel's wrapper and its plain versions.

``mlstm_chunkwise`` takes the model layout of the JAX package's
``repro.kernels.mlstm_scan.ops.mlstm_chunkwise``: q/k/v (B, S, H, dh)
f32 (q not yet scaled), input and forget gate pre-activations i/f
(B, S, H) f32, and a state {"C": (B, H, dh, dh), "n": (B, H, dh),
"m": (B, H)}; it returns (h (B, S, H, dh), new state).  On CUDA tensors
it launches ``csrc/mlstm_scan.cu``, which replaces the Pallas
``_mlstm_kernel`` of ``src/repro/kernels/mlstm_scan/kernel.py`` (see the
source for the design and what bounds it; it takes head dims that are
multiples of 8 up to 1024); on CPU tensors it runs
``mlstm_chunkwise_plain``.

Beside it, the plain versions:

* ``mlstm_chunkwise_plain`` -- the port of
  ``repro.models.ssm._mlstm_cell_chunkwise``: the same closed form as
  the kernel, chunk by chunk in torch ops;
* ``mlstm_sequential`` -- the port of ``repro.models.ssm._mlstm_cell_seq``:
  the stabilised recurrence one step at a time.  ``models.ssm.mlstm_step``
  decodes through it, and the tests hold the other two against it.

The kernel's chunk length is ``pick_chunk(S, 64)``, the largest divisor
of S not above 64, as the JAX model path takes it, so any prompt length
runs; a launch-config table (``kernels.tiles``) or the caller may set
another that the kernel takes (``forward_chunk``), and the backward then
takes the forward's.  ``mlstm_chunkwise_plain`` also takes other chunk
lengths, as the JAX reference does.  On meta tensors (the dry run) the
wrapper gives the outputs' shapes and, inside a counted region
(``launch.op_costs``), records ``forward_cost`` / ``backward_cost``.
Under the sanitizer (``kernels.sanitize``) its inputs and outputs are
checked after the call.

The gradient: when grad mode is on and q, k, v or a gate needs one,
``mlstm_chunkwise`` runs as ``_MlstmChunkwise`` (a
``torch.autograd.Function``): on CUDA tensors the forward kernel and the
backward kernel ``csrc/mlstm_scan_bwd.cu`` (``mlstm_chunkwise_bwd``; no
Pallas counterpart: the JAX package differentiates
``_mlstm_cell_chunkwise`` with XLA); on CPU tensors the plain version
and ``mlstm_chunkwise_grad_plain``, autograd of it.  The backward takes
its own chunk, ``backward_chunk(S, dh, L)``: the whole sequence where that
takes fewer operations (no state products, and the forward writes no
states), else the forward's chunk, from C and n at each chunk's start,
which the forward kernel then writes.  A caller that built the initial
state as zeros says so (``zero_state=True``, as ``models.ssm.mlstm_full``
does without a state) and the backward skips the products that read it.
Training starts from a state that needs no gradient and reads no final
state, so the backward takes no gradient into the initial state and none
out of the final one: an initial state that requires grad is refused
before anything runs, and a non-zero gradient arriving at the final state
raises.  ``mlstm_chunkwise_bwd_explicit`` writes the backward kernel's
formulas out in torch, for the tests.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, sanitize, tiles
from repro_torch.launch import op_costs
from repro_torch.models.scan_utils import pick_chunk

MAX_CHUNK = 64        # the kernel's in-chunk tile is 64 x 64
MAX_HEAD_DIM = 1024   # a block's 32 columns of C fill its shared memory


def log_sigmoid(x):
    """log(sigmoid(x)) in the overflow-free form the kernel uses."""
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


def forward_chunk(B: int, S: int, chunk: int | None = None) -> int:
    """The forward kernel's chunk L for batch ``B`` over S steps:
    ``chunk``, or unset the launch-config table's entry at ``B``
    (``kernels.tiles``) where the kernel takes it (at most
    ``MAX_CHUNK``, dividing S), else ``pick_chunk(S, MAX_CHUNK)``."""
    if chunk is None:
        default = pick_chunk(S, MAX_CHUNK)
        chunk = tiles.tile_for("mlstm_scan", B, "chunk", default)
        return chunk if valid_chunk(chunk, S) else default
    if not valid_chunk(chunk, S):
        raise ValueError(f"mlstm_chunkwise: chunk {chunk} must divide S={S} "
                         f"and be at most {MAX_CHUNK}")
    return chunk


def valid_chunk(L: int, S: int) -> bool:
    """Whether the forward kernel takes chunk ``L`` over S steps."""
    return 1 <= L <= MAX_CHUNK and S % L == 0


def backward_chunk(S: int, dh: int, L: int | None = None) -> int:
    """The backward kernel's chunk for S steps at head dim dh: S (one
    chunk, so the state's gradient and its products drop out) or the
    forward's chunk L (default ``pick_chunk(S, MAX_CHUNK)``), whichever
    takes fewer operations.  A row costs 5 S^2 dh with one chunk (the
    five in-chunk products, causal) against S (8 dh^2 + 5 L dh) with
    chunks of L (four state products of 2 L dh^2 a chunk beside the
    five), so one chunk wins up to S of about 1.6 dh + L."""
    if L is None:
        L = pick_chunk(S, MAX_CHUNK)
    return S if 5 * S * dh <= 8 * dh * dh + 5 * L * dh else L


def forward_cost(B, S, H, dh, L, keep_states=False) -> tuple[int, int]:
    """(f32 operations, bytes) of one forward call at chunk L: per row
    and chunk q k^T and (W * S) v (2 L^2 dh each), q C and k^T v (2 L
    dh^2 each) and the normaliser's q n (2 L dh, the kernel's extra
    n-tile); q, k, v, h, both states, i, f and m moved once, and the
    chunk-start states when written."""
    nbytes = 4 * (4 * B * S * H * dh + 2 * B * H * dh * dh + 2 * B * H * dh
                  + 2 * B * S * H + 2 * B * H)
    if keep_states:
        nbytes += 4 * B * H * (S // L) * (dh * dh + dh + 1)
    return (B * H * (S // L) * (4 * L * L * dh + 4 * L * dh * dh
                                 + 2 * L * dh), nbytes)


def backward_cost(B, S, H, dh, L) -> tuple[int, int]:
    """(f32 operations, bytes) of one backward call at its chunk L
    (``backward_chunk``).  One chunk (L = S): per row q k^T, dh v^T,
    dS k, dS^T q and P'^T dh over the causal pairs (2 dh each); q, k,
    v, h, dh read and dq, dk, dv written, i, f read and di, df written,
    m0.  Chunks of L: per row and chunk those five over the whole L x L
    tile and C dnum, G v, G^T k and (a q)^T dnum (2 L dh^2 each), the
    chunk-start states read too."""
    io = 8 * B * S * H * dh + 4 * B * S * H + B * H
    if L == S:
        return B * H * 5 * dh * S * (S + 1), 4 * io
    nc = S // L
    return (B * H * nc * (8 * L * dh * dh + 10 * L * L * dh),
            4 * (io + B * H * nc * (dh * dh + dh)))


def mlstm_chunkwise_plain(q, k, v, i_pre, f_pre, state, chunk=MAX_CHUNK):
    """Chunkwise-parallel mLSTM in torch ops; same arguments and
    results as ``mlstm_chunkwise``."""
    h, out, _ = _chunkwise(q, k, v, i_pre, f_pre, state, chunk, False)
    return h, out


def _chunkwise(q, k, v, i_pre, f_pre, state, chunk, keep_states):
    """``mlstm_chunkwise_plain``'s (h, final state), and with
    ``keep_states`` C, n and m at each chunk's start ((B, H, S / L, dh,
    dh), (B, H, S / L, dh), (B, H, S / L)) as the forward kernel writes
    them, else None."""
    B, T, H, dh = q.shape
    L = pick_chunk(T, chunk)
    qs = q * (1.0 / math.sqrt(dh))
    C, n, m = state["C"], state["n"], state["m"]
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    hs, starts = [], []
    for c0 in range(0, T, L):
        if keep_states:
            starts.append((C, n, m))
        sl = slice(c0, c0 + L)
        qc, kc, vc, ic, fc = qs[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], \
            f_pre[:, sl]
        F = torch.cumsum(log_sigmoid(fc), dim=1)                  # (B,L,H)
        g = torch.cummax(ic - F, dim=1).values
        m_t = F + torch.maximum(m[:, None], g)

        w_inter = torch.exp(F + m[:, None] - m_t)
        num = w_inter[..., None] * torch.einsum("blhk,bhkv->blhv", qc, C)
        den = w_inter * torch.einsum("blhk,bhk->blh", qc, n)

        logw = (F - m_t)[:, :, None] + (ic - F)[:, None]          # (B,Lq,Ls,H)
        W = torch.where(causal[None, :, :, None], logw,
                        torch.full_like(logw, -math.inf)).exp()
        WS = W * torch.einsum("blhk,bshk->blsh", qc, kc)
        num = num + torch.einsum("blsh,bshv->blhv", WS, vc)
        den = den + WS.sum(dim=2)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])

        m_last = m_t[:, -1]                                       # (B,H)
        kw = kc * torch.exp((F[:, -1:] - F) + ic - m_last[:, None])[..., None]
        decay = torch.exp(F[:, -1] + m - m_last)
        C = decay[..., None, None] * C + torch.einsum("bshk,bshv->bhkv",
                                                      kw, vc)
        n = decay[..., None] * n + kw.sum(dim=1)
        m = m_last
    states = (tuple(torch.stack(x, dim=2) for x in zip(*starts))
              if keep_states else None)
    return torch.cat(hs, dim=1), {"C": C, "n": n, "m": m}, states


def mlstm_sequential(q, k, v, i_pre, f_pre, state):
    """The stabilised mLSTM recurrence one time step at a time; same
    arguments and results as ``mlstm_chunkwise``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], i_pre[:, t], \
            f_pre[:, t]
        logf = log_sigmoid(ft)                                    # (B,H)
        m_new = torch.maximum(logf + m, it)
        f_act = torch.exp(logf + m - m_new)[..., None, None]
        i_act = torch.exp(it - m_new)[..., None, None]
        C = f_act * C + i_act * (kt[..., :, None] * vt[..., None, :])
        n = f_act[..., 0] * n + i_act[..., 0] * kt
        qs = qt * scale
        num = torch.einsum("bhkv,bhk->bhv", C, qs)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qs).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), {"C": C, "n": n, "m": m}


def _check(q, k, v, i_pre, f_pre, state):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_chunkwise: want q/k/v (B,S,H,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    want = {"i_pre": (i_pre, (B, S, H)), "f_pre": (f_pre, (B, S, H)),
            "C": (state["C"], (B, H, dh, dh)), "n": (state["n"], (B, H, dh)),
            "m": (state["m"], (B, H))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mlstm_chunkwise: {name} {tuple(t.shape)}, "
                             f"want {shape}")
    tensors = (q, k, v, i_pre, f_pre, state["C"], state["n"], state["m"])
    if any(t.device != q.device for t in tensors):
        raise ValueError("mlstm_chunkwise: inputs on different devices")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("mlstm_chunkwise: inputs and state must be float32")
    if S < 1:
        raise ValueError("mlstm_chunkwise: empty sequence")


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes
    (a view into a larger tensor)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, i_pre, f_pre, state, keep_states, chunk=None):
    """The forward kernel at chunk ``forward_chunk(B, S, chunk)``: (h,
    {"C", "n", "m"}, and with ``keep_states`` C, n and m at each chunk's
    start (Cst, nst, mst), else None); on meta tensors their shapes
    alone."""
    B, S, H, dh = q.shape
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_chunkwise: head_dim {dh} must be a multiple "
                         f"of 8 and at most {MAX_HEAD_DIM}")
    L = forward_chunk(B, S, chunk)
    states = None
    if keep_states:
        states = (torch.empty(B, H, S // L, dh, dh, device=q.device),
                  torch.empty(B, H, S // L, dh, device=q.device),
                  torch.empty(B, H, S // L, device=q.device))
    if q.device.type == "meta":
        return (_like(q), {n: _like(t) for n, t in state.items()}, states)
    # the kernel stages rows with 16-byte copies: 16-byte aligned inputs
    args = [_aligned(t.detach().contiguous())
            for t in (q, k, v, i_pre, f_pre, state["C"], state["n"],
                      state["m"])]
    h = torch.empty_like(args[0])
    C1, n1, m1 = (torch.empty_like(t) for t in args[5:])
    lib = build.library()
    work = torch.empty(lib.size("tryage_mlstm_scan_workspace", B, S, H, L),
                       dtype=torch.float32, device=q.device)
    build.launch(
        "tryage_mlstm_scan", q.device, *(t.data_ptr() for t in args),
        h.data_ptr(), C1.data_ptr(), n1.data_ptr(), m1.data_ptr(),
        work.data_ptr(),
        *((None,) * 3 if states is None else (t.data_ptr() for t in states)),
        B, S, H, dh, L, 1.0 / math.sqrt(dh))
    mlstm_chunkwise.launches += 1
    return h, {"C": C1, "n": n1, "m": m1}, states


def mlstm_chunkwise_grad_plain(q, k, v, i_pre, f_pre, state, dh,
                               chunk=MAX_CHUNK):
    """(dq, dk, dv, di, df) of ``mlstm_chunkwise_plain``'s h given its
    gradient ``dh``, by torch autograd, from a state that takes no
    gradient: the plain version the backward kernel is held against."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (q, k, v, i_pre, f_pre)]
        state = {n: t.detach() for n, t in state.items()}
        h, _ = mlstm_chunkwise_plain(*leaves, state, chunk)
        return torch.autograd.grad(h, leaves, dh)


def mlstm_chunkwise_bwd(q, k, v, i_pre, f_pre, state, h, dh, states=None,
                        zero_state=False, chunk=None):
    """(dq, dk, dv, di, df) of the scan's h from ``state``, given h (the
    forward's output) and its gradient ``dh``: ``csrc/mlstm_scan_bwd.cu``
    on CUDA tensors, at the chunk ``backward_chunk(S, dh, chunk)``: with one
    chunk from ``state`` (``states`` None), else from ``states`` =
    (Cst, nst, mst), C, n and m at each chunk's start as the forward
    kernel writes them with ``keep_states``.  ``zero_state``: the caller built
    ``state`` as zeros, so the products that read it are skipped (never
    read off the tensor: that would wait on the card).  ``chunk``: the
    forward's chunk (default ``pick_chunk(S, MAX_CHUNK)``), which the
    backward takes where it takes chunks.
    ``mlstm_chunkwise_grad_plain`` on CPU tensors, which needs neither h
    nor ``states``; the gradients' shapes alone on meta ones."""
    _check(q, k, v, i_pre, f_pre, state)
    B, S, H, d = q.shape
    L = backward_chunk(S, d, chunk)
    return op_costs.kernel_call(
        "mlstm_scan_bwd", lambda: backward_cost(B, S, H, d, L), _backward,
        q, k, v, i_pre, f_pre, state, h, dh, states, zero_state, L,
        chunk or MAX_CHUNK)


def _backward(q, k, v, i_pre, f_pre, state, h, dh, states, zero_state, L,
              fwd_chunk):
    ins = (q, k, v, i_pre, f_pre)
    if q.device.type == "meta":
        return tuple(_like(t) for t in ins)
    if q.device.type == "cpu":
        return tuple(_like(t).copy_(g) for t, g in zip(
            ins, mlstm_chunkwise_grad_plain(*ins, state, dh, fwd_chunk)))
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise_bwd: no kernel for {q.device}")
    if h.shape != q.shape or dh.shape != q.shape or dh.dtype != q.dtype:
        raise ValueError(f"mlstm_chunkwise_bwd: h {tuple(h.shape)}, dh "
                         f"{tuple(dh.shape)} do not fit q {tuple(q.shape)}")
    B, S, H, d = q.shape
    if L == S:
        if states is not None:
            raise ValueError("mlstm_chunkwise_bwd: one chunk reads the "
                             "initial state, not the chunk-start states")
        states = (state["C"], state["n"], state["m"])
    else:
        want = ((B, H, S // L, d, d), (B, H, S // L, d), (B, H, S // L))
        if states is None or len(states) != 3 or any(
                tuple(t.shape) != w for t, w in zip(states, want)):
            raise ValueError(f"mlstm_chunkwise_bwd: states "
                             f"{states and [tuple(t.shape) for t in states]}"
                             f", want {want}")
    args = [_aligned(t.detach().contiguous())
            for t in (q, k, v, i_pre, f_pre, state["m"], *states, h, dh)]
    grads = [torch.empty_like(t) for t in args[:5]]
    lib = build.library()
    work = torch.empty(
        lib.size("tryage_mlstm_scan_bwd_workspace", B, S, H, d, L),
        dtype=torch.float32, device=q.device)
    build.launch(
        "tryage_mlstm_scan_bwd", q.device, *(t.data_ptr() for t in args),
        *(t.data_ptr() for t in grads), work.data_ptr(), B, S, H, d, L,
        int(zero_state), 1.0 / math.sqrt(d))
    mlstm_chunkwise_bwd.launches += 1
    return tuple(grads)


def mlstm_chunkwise_bwd_explicit(q, k, v, i_pre, f_pre, state, dh,
                                 chunk=None, zero_state=False):
    """(dq, dk, dv, di, df) by the backward kernel's formulas written out
    in torch, at the backward's chunk ``chunk`` (default
    ``backward_chunk``), from C and n at each chunk's start, with the
    stabiliser held constant and, with ``zero_state``, the initial
    state's products skipped.  The tests hold it against ``jax.grad``;
    nothing on the main path calls it.

    Per row, in f64 as the kernel keeps them: F the cumulative
    log-sigmoid of f over the sequence, g_s = i_s - F_s and M_t =
    max(m0, max_{s <= t} g_s), so m_t = F_t + M_t and, in a chunk that
    starts after step c0 - 1, D_ts = e^{g_s - M_t}, a_t = e^{M_{c0-1} -
    M_t}, w_s = e^{g_s - M_end}, decay = e^{M_{c0-1} - M_end} and the
    floor e^{-m_t}; the forward's chunk-start states, scaled by its own
    f32 stabiliser m_c, are read with a_t kappa, kappa = e^{m_c - F_{c0-1}
    - M_{c0-1}}.  With r_t = 1 / max(|den_t|, e^{-m_t}) and dden_t as
    the kernel's header says: dP = r dh v^T + dden, dS = dP D / sqrt(dh),
    P' = r P; dq = dS k (+ a / sqrt(dh) (r dh C^T + dden n)), dk = dS^T q
    (+ w (v G^T + dn)), dv = P'^T dh (+ w k G); G and dn of each chunk in
    reverse."""
    B, S, H, d = q.shape
    L = backward_chunk(S, d) if chunk is None else chunk
    nc, scale = S // L, 1.0 / math.sqrt(d)
    h, _, _ = _chunkwise(q, k, v, i_pre, f_pre, state, MAX_CHUNK, False)
    if L == S:
        Cst, nst, mst = (state[x][:, :, None] for x in "Cnm")
    else:
        _, _, (Cst, nst, mst) = _chunkwise(q, k, v, i_pre, f_pre, state, L,
                                           True)
    qh, kh, vh, hh, gh = (t.transpose(1, 2) for t in (q, k, v, h, dh))
    F = log_sigmoid(f_pre).double().transpose(1, 2).cumsum(-1)   # (B,H,S)
    g = i_pre.double().transpose(1, 2) - F
    m0 = state["m"].double()
    M = torch.maximum(torch.cummax(g, -1).values, m0[..., None])
    lo = torch.exp(-(F + M)).float()
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    G = torch.zeros(B, H, d, d, dtype=q.dtype, device=q.device)
    dn = torch.zeros(B, H, d, dtype=q.dtype, device=q.device)
    outs = []
    for c in reversed(range(nc)):
        sl = slice(c * L, (c + 1) * L)
        M_prev = m0 if c == 0 else M[..., c * L - 1]
        F_prev = 0.0 if c == 0 else F[..., c * L - 1]
        # the forward's states carry its own f32 stabiliser at the chunk's
        # start: kappa takes them to this one (1 for one chunk)
        kappa = torch.exp(mst[:, :, c].double() - F_prev - M_prev).float()
        M_t, g_c, M_end = M[..., sl], g[..., sl], M[..., (c + 1) * L - 1]
        a = torch.exp(M_prev[..., None] - M_t).float()
        w = torch.exp(g_c - M_end[..., None]).float()
        decay = torch.exp(M_prev - M_end).float()
        E = torch.where(causal, torch.exp(g_c[..., None, :]
                                          - M_t[..., :, None]),
                        0.0).float() * scale
        qc, kc, vc, hc, gc = (t[:, :, sl] for t in (qh, kh, vh, hh, gh))
        Cc, n_c = Cst[:, :, c], nst[:, :, c]
        has_state = c > 0 or not zero_state
        P = E * (qc @ kc.transpose(-1, -2))
        a_st = kappa[..., None] * a          # a for the forward's states
        qn = (qc * n_c[:, :, None]).sum(-1) if has_state else 0.0
        den = a_st * scale * qn + P.sum(-1)
        r = 1.0 / torch.maximum(den.abs(), lo[..., sl])
        dden = torch.where(den.abs() > lo[..., sl],
                           -torch.sign(den) * (gc * hc).sum(-1) * r, 0.0)
        dP = r[..., None] * (gc @ vc.transpose(-1, -2)) + dden[..., None]
        dS, l = dP * E, dP * P
        dq_c = dS @ kc
        dk_c = dS.transpose(-1, -2) @ qc
        dv_c = (r[..., None] * P).transpose(-1, -2) @ gc
        ar = scale * a * r
        da = ww = dd = 0.0
        if has_state:
            u = (scale * a_st * r)[..., None] * (gc @ Cc.transpose(-1, -2))
            dq_c = dq_c + u + (scale * a_st * dden)[..., None] * n_c[:, :, None]
            da = (qc * u).sum(-1) + scale * a_st * dden * qn
        if c < nc - 1:
            y = kc @ G
            dk_c = dk_c + w[..., None] * (vc @ G.transpose(-1, -2)
                                          + dn[:, :, None])
            dv_c = dv_c + w[..., None] * y
            ww = w * ((vc * y).sum(-1) + (kc * dn[:, :, None]).sum(-1))
            if has_state:
                dd = kappa * ((G * Cc).sum((-1, -2)) + (dn * n_c).sum(-1))
        cs = l.sum(-2)
        dF = l.sum(-1) - cs + da - ww
        di_c = cs + ww
        tail = dd * decay + (ww.sum(-1) if c < nc - 1 else 0.0)
        dF = torch.cat([dF[..., :-1], dF[..., -1:] + (
            tail[..., None] if torch.is_tensor(tail) else tail)], -1)
        dlog = dF.flip(-1).cumsum(-1).flip(-1)
        df_c = dlog / (1.0 + torch.exp(f_pre[:, sl].transpose(1, 2)))
        outs.append((dq_c, dk_c, dv_c, di_c, df_c))
        if c > 0:
            G = decay[..., None, None] * G + (ar[..., None] * qc).transpose(
                -1, -2) @ gc
            dn = decay[..., None] * dn + ((scale * a * dden)[..., None]
                                          * qc).sum(-2)
    outs.reverse()
    dq, dk, dv, di, df = (torch.cat(parts, dim=2)
                          for parts in zip(*outs))
    return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
            di.transpose(1, 2), df.transpose(1, 2))


class _MlstmChunkwise(torch.autograd.Function):
    """The scan as one differentiable op from a state that takes no
    gradient: the forward kernel at chunk L (writing the chunk-start
    states when the backward takes chunks shorter than the sequence) and
    the backward kernel on CUDA (or meta) tensors, the plain version and
    its autograd on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, C0, n0, m0, zero_state, L):
        state = {"C": C0, "n": n0, "m": m0}
        keep = backward_chunk(q.shape[1], q.shape[3], L) < q.shape[1]
        if q.device.type == "cpu":
            # the plain backward needs no states; they are kept as the
            # kernel keeps them, so that the CPU's memory is the card's
            h, out, states = _chunkwise(q, k, v, i_pre, f_pre, state, L,
                                        keep)
            h, out = _as_written(q, state, h, out)
        else:
            h, out, states = _launch(q, k, v, i_pre, f_pre, state, keep, L)
        ctx.set_materialize_grads(False)
        ctx.zero_state, ctx.chunk = zero_state, L
        ctx.save_for_backward(q, k, v, i_pre, f_pre, C0, n0, m0, h,
                              *(states or ()))
        return h, out["C"], out["n"], out["m"]

    @staticmethod
    def backward(ctx, dh, dC1, dn1, dm1):
        for name, g in (("C", dC1), ("n", dn1), ("m", dm1)):
            if (g is not None and g.device.type != "meta"
                    and bool((g != 0).any())):
                raise RuntimeError(
                    f"mlstm_chunkwise: a gradient reached the final state's "
                    f"{name!r}; the backward takes none out of the final "
                    f"state (training reads no state)")
        q, k, v, i_pre, f_pre, C0, n0, m0, h, *states = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        state = {"C": C0, "n": n0, "m": m0}
        grads = mlstm_chunkwise_bwd(q, k, v, i_pre, f_pre, state, h,
                                    dh.contiguous(), states or None,
                                    ctx.zero_state, ctx.chunk)
        return (*grads, None, None, None, None, None)


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state, zero_state=False,
                    chunk=None):
    """The mLSTM over a sequence from ``state``: the kernel on CUDA
    tensors, ``mlstm_chunkwise_plain`` on CPU ones, the outputs' shapes
    alone on meta ones, each through ``_MlstmChunkwise`` when a gradient
    is needed.  ``zero_state``: the caller built ``state`` as zeros (the
    backward kernel then skips the products that read it).  ``chunk``:
    the forward's chunk (``forward_chunk``; unset: the table's, else
    ``pick_chunk(S, MAX_CHUNK)``).  Under the sanitizer the inputs, the
    incoming stabilizer state m (held to +-``MLSTM_M_RANGE``), h and the
    new m are checked after the call.  Returns (h (B, S, H, dh),
    {"C", "n", "m"})."""
    _check(q, k, v, i_pre, f_pre, state)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"mlstm_chunkwise: no kernel for {q.device}")
    B, S, H, dh = q.shape
    L = forward_chunk(B, S, chunk)
    grad = False
    if torch.is_grad_enabled():
        if any(t.requires_grad for t in state.values()):
            raise RuntimeError(
                "mlstm_chunkwise: the initial state requires grad; the "
                "backward takes no gradient into the state (training starts "
                "from zeros): detach it")
        grad = any(t.requires_grad for t in (q, k, v, i_pre, f_pre))
    keep = grad and backward_chunk(S, dh, L) < S
    h, out = op_costs.kernel_call(
        "mlstm_scan", lambda: forward_cost(B, S, H, dh, L, keep), _scan,
        q, k, v, i_pre, f_pre, state, zero_state, L, grad)
    if sanitize.wrapper_checks():
        R = sanitize.MLSTM_M_RANGE
        sanitize.run_checks(
            sanitize.check_finite("mlstm_scan", "input", q, k, v, i_pre,
                                  f_pre),
            sanitize.check_in_range("mlstm_scan", "stabilizer state m",
                                    state["m"], -R, R),
            sanitize.check_finite("mlstm_scan", "output", h),
            sanitize.check_in_range("mlstm_scan", "new stabilizer state m",
                                    out["m"], -R, R))
    return h, out


def _scan(q, k, v, i_pre, f_pre, state, zero_state, L, grad):
    if grad:
        h, C1, n1, m1 = _MlstmChunkwise.apply(
            q, k, v, i_pre, f_pre, state["C"], state["n"], state["m"],
            zero_state, L)
        return h, {"C": C1, "n": n1, "m": m1}
    if q.device.type == "cpu":
        return _as_written(q, state, *mlstm_chunkwise_plain(
            q, k, v, i_pre, f_pre, state, L))
    h, out, _ = _launch(q, k, v, i_pre, f_pre, state, False, L)
    return h, out


def _like(t):
    """An output of the kernel's for input ``t``: laid out as ``t``
    made contiguous (meta too, for the dry run)."""
    return torch.empty_like(t.contiguous())


def _as_written(q, state, h, out):
    """The plain version's (h, state) laid out as the kernel writes them,
    so that what follows runs the same ops as on the card."""
    return (_like(q).copy_(h),
            {n: _like(state[n]).copy_(t) for n, t in out.items()})


mlstm_chunkwise.launches = 0
mlstm_chunkwise_bwd.launches = 0
