"""Columnar placement step: CUDA pool/score kernels and plain versions.

The port of ``repro/kernels/placement.py`` (TPU kernels ``_pool_kernel``
and ``_score_kernel``).  The columnar engine
(:class:`repro_torch.core.columnar.ColumnarPlacement`) advances every
(theta, kappa) branch of the SJF-BCO forest by one job per step; per step
it needs the Eq. (16) feasibility pools (``U + rho/u <= theta + 1e-9``),
the per-server busy/feasible-count reductions behind the FA-FFP/LBSGF
picks and the picks' stable GPU rankings, and the Eq. (6)-(8) tau/rho
scoring of the probed candidates.

  * :func:`pool_stats` (kernel ``"pool"``) -- the pool counts at each
    work row's two extreme thetas, GPU-id-order per-server busy sums,
    feasible-slot counts, the FA-FFP best server, and each row's full
    stable pick ordering (FA-FFP or LBSGF by its picker id) with its
    pool-large-enough flag, one block per row;
  * :func:`score_rows` (kernel ``"score"``) -- Eq. (7) k, f and gamma and
    Eq. (8) tau with the rho-hat slot count per probed candidate, one warp
    per candidate.

:func:`pick_orders` and :func:`score_probes` are the NumPy-in/NumPy-out
entry points the engine calls.  On the card each packs its inputs into
one pinned host buffer and makes one C call (``pool_step`` /
``score_step`` in ``csrc/placement.cu``): one copy up, one launch, one
copy back into another pinned buffer and one wait.  The buffers are kept
per (cluster, device) and grown as needed (:class:`_Staging`).

A CPU tensor runs the plain PyTorch version beside each wrapper
(:func:`pool_stats_plain`, :func:`score_rows_plain`).  Everything is
float64; the per-server sums replay ``np.bincount``'s sequential GPU-id
order (no ``torch.sum`` over floats) and the rankings are stable sorts,
so both backends are bit-identical to the NumPy pickers.  Shapes are
taken at run time, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.tau import cluster_tensors, to_device

__all__ = ["pick_orders", "score_probes", "pool_stats", "pool_stats_plain",
           "score_rows", "score_rows_plain"]

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    "pool_stats": [_P] * 5 + [_L, _D] + [_P] * 3 + [_I] * 3 + [_P, _P],
    "pool_step": [_P, _P, _L, _D] + [_P] * 3 + [_I] * 3 + [_P, _P, _L, _P],
    "score_rows": [_P] * 5 + [_I] * 3 + [_D] * 10 + [_P, _P],
    "score_step": [_P] * 5 + [_I] * 3 + [_D] * 10 + [_P] * 3,
}

#: GPUs of a row one shared-memory pass of the pool kernel holds
#: (``kChunk`` in ``csrc/placement.cu``); wider rows go in chunks.
_POOL_CHUNK = 2048
_MAX_SMEM = 227 * 1024


def _pool_smem(N: int, S: int) -> int:
    """Dynamic shared memory of a pool-kernel block (as the C side sizes
    it): 48 bytes a server, 16 a GPU of one chunk."""
    return 48 * S + 16 * min(N, _POOL_CHUNK)


def pool_words(B: int, N: int, S: int) -> int:
    """int64 words of the pool kernel's packed output: c_lo, c_hi, ok
    [B] and order [B, N] first (what :func:`pick_orders` copies back),
    then best_srv, has_fit [B], load (float64 bits) and cnt [B, S]; the
    flags ok and has_fit are B bool bytes at the start of their B words."""
    return 5 * B + B * N + 2 * B * S


def unpack_pool(packed: torch.Tensor, B: int, N: int, S: int):
    """``(c_lo, c_hi, load, cnt, best_srv, has_fit, order, ok)``: views of
    a packed pool output, no copies."""
    o = 3 * B + B * N
    return (packed[:B], packed[B:2 * B],
            packed[o + 2 * B:o + 2 * B + B * S].view(torch.float64)
            .view(B, S),
            packed[o + 2 * B + B * S:o + 2 * B + 2 * B * S].view(B, S),
            packed[o:o + B], packed[o + B:o + 2 * B].view(torch.bool)[:B],
            packed[3 * B:o].view(B, N),
            packed[2 * B:3 * B].view(torch.bool)[:B])


def pool_stats_plain(U, th_lo, th_hi, rho_u, pid, G, lam_G, offsets, caps,
                     gpu_server):
    """Plain PyTorch version of the pool kernel (K3).

    Returns ``(c_lo, c_hi, load, cnt, best_srv, has_fit, order, ok)``.
    The busy sums add each server's clocks one GPU column at a time in
    GPU-id order (trailing lanes of smaller servers add +0.0, the identity
    for the non-negative clocks), exactly ``np.bincount``'s sequence.  The
    rankings are ``torch.argsort(stable=True)``: FA-FFP over its masked
    clocks, LBSGF by clock and then by server rank (a lexsort)."""
    B, N = U.shape
    S = caps.shape[0]
    V = U + rho_u[:, None]
    lo = (th_lo + 1e-9)[:, None]
    feas = V <= lo
    c_lo = feas.sum(dim=1)
    c_hi = (V <= (th_hi + 1e-9)[:, None]).sum(dim=1)
    load = torch.zeros((B, S), dtype=U.dtype, device=U.device)
    cnt = torch.zeros((B, S), dtype=torch.int64, device=U.device)
    for i in range(int(caps.max()) if S else 0):       # GPU-id order
        valid = i < caps
        idx = torch.clamp(offsets + i, max=N - 1)
        load = load + torch.where(valid, U[:, idx], 0.0)
        cnt = cnt + (valid & feas[:, idx])
    # FA-FFP best server: lexicographic min over (feasible slots left,
    # -load, server id) as staged masked argmins, first index on ties.
    fits = cnt >= G
    has_fit = fits.any(dim=1)
    k_fit = torch.where(fits, cnt - G, N + 1)
    k_occ = torch.where(fits, -load, float("inf"))
    t1 = k_fit == k_fit.amin(dim=1, keepdim=True)
    k2 = torch.where(t1, k_occ, float("inf"))
    t2 = t1 & (k2 == k2.amin(dim=1, keepdim=True))
    best_srv = t2.to(torch.int32).argmax(dim=1)
    # FA-FFP: pack into the best-fit server when one fits, else spread
    # over the whole pool.
    inf = float("inf")
    in_best = feas & (gpu_server[None, :] == best_srv[:, None])
    keys = torch.where(has_fit[:, None], torch.where(in_best, U, inf),
                       torch.where(feas, U, inf))
    order_fa = torch.argsort(keys, dim=1, stable=True)
    # LBSGF: least-busy server prefix of lambda_j * G capacity, then
    # server-rank-major / least-U order.
    srv_order = torch.argsort(load / caps.to(U.dtype), dim=1, stable=True)
    cum = torch.cumsum(caps[srv_order], dim=1)
    m = torch.clamp((cum.to(torch.float64) < lam_G).sum(dim=1) + 1, max=S)
    pos = torch.arange(S, device=U.device).expand(B, S)
    srv_rank = torch.empty_like(srv_order).scatter_(
        1, srv_order, torch.where(pos < m[:, None], pos, -1))
    ranks = srv_rank[:, gpu_server]
    pool = feas & (ranks >= 0)
    by_u = torch.argsort(torch.where(pool, U, inf), dim=1, stable=True)
    by_rank = torch.argsort(torch.where(pool, ranks, S + 1).gather(1, by_u),
                            dim=1, stable=True)
    lb = pid == 1
    order = torch.where(lb[:, None], by_u.gather(1, by_rank), order_fa)
    ok = torch.where(lb, pool.sum(dim=1) >= G, c_lo >= G)
    return c_lo, c_hi, load, cnt, best_srv, has_fit, order, ok


def _check_pool(U, th_lo, th_hi, rho_u, pid, offsets, caps, gpu_server):
    """Shapes of the pool kernel's operands; returns (B, N, S)."""
    if U.dim() != 2:
        raise ValueError(f"U must be [B, N], got {tuple(U.shape)}")
    B, N = U.shape
    dev = U.device
    _build.check(U, "U", torch.float64, (B, N), dev)
    for name, t in (("th_lo", th_lo), ("th_hi", th_hi), ("rho_u", rho_u)):
        _build.check(t, name, torch.float64, (B,), dev)
    _build.check(pid, "pid", torch.int64, (B,), dev)
    S = caps.shape[0]
    _build.check(offsets, "offsets", torch.int64, (S,), dev)
    _build.check(caps, "caps", torch.int64, (S,), dev)
    _build.check(gpu_server, "gpu_server", torch.int64, (N,), dev)
    _check_widths(N, S)
    return B, N, S


def _check_widths(N: int, S: int) -> None:
    """Raise unless a pool-kernel block can hold a row of N GPUs on S
    servers."""
    if N < 1 or S < 1:
        raise ValueError(f"the pool kernel needs GPUs and servers, got "
                         f"N={N}, S={S}")
    if _pool_smem(N, S) > _MAX_SMEM:
        raise ValueError(f"{S} servers need {_pool_smem(N, S)} bytes of "
                         f"shared memory a row, over the pool kernel's "
                         f"{_MAX_SMEM}")


def pool_stats(U, th_lo, th_hi, rho_u, pid, G: int, lam_G: float, offsets,
               caps, gpu_server):
    """K3 wrapper over one step's work rows.

    ``U`` [B, N] float64 busy-time clocks; ``th_lo``/``th_hi``/``rho_u``
    [B] float64 (each row's extreme thetas and escalated rho/u charge);
    ``pid`` [B] int64 picker ids (0 = FA-FFP, 1 = LBSGF); ``G`` the job's
    GPU count and ``lam_G`` its lambda * G; ``offsets``/``caps`` [S] int64
    (each server's first GPU id and capacity) and ``gpu_server`` [N]
    int64.  Returns ``(c_lo [B] i64, c_hi [B] i64, load [B, S] f64, cnt
    [B, S] i64, best_srv [B] i64, has_fit [B] bool, order [B, N] i64, ok
    [B] bool)``: the pick is ``order[b, :G]`` where ``ok[b]``."""
    B, N, S = _check_pool(U, th_lo, th_hi, rho_u, pid, offsets, caps,
                          gpu_server)
    G, lam_G = int(G), float(lam_G)
    if U.device.type == "cpu":
        return pool_stats_plain(U, th_lo, th_hi, rho_u, pid, G, lam_G,
                                offsets, caps, gpu_server)
    packed = torch.empty(pool_words(B, N, S), dtype=torch.int64,
                         device=U.device)
    if B:
        _build.launch("placement", _SIGNATURES, "pool_stats", U.device,
                      *(t.data_ptr() for t in (U, th_lo, th_hi, rho_u, pid)),
                      G, lam_G, offsets.data_ptr(), caps.data_ptr(),
                      gpu_server.data_ptr(), B, N, S, packed.data_ptr())
        LAUNCHES["pool"] += 1
    return unpack_pool(packed, B, N, S)


def score_rows_plain(Y, p, speed_floor, uplink_sh, uplink_iso, scalars, *,
                     hetero, xi1, xi2, alpha, b_inter, b_intra):
    """Plain PyTorch version of the score kernel (K4): the expressions of
    ``contention.degradation``, ``scalar_tau_many`` and ``slots_for_many``
    in their order.  Every division is tensor by tensor (see
    ``tau._full``)."""
    two_share, share, reduce_const, compute, iters = scalars
    pos = Y > 0
    n_srv = pos.sum(dim=1)
    k = torch.clamp(xi1 * p, min=1.0)
    f = k + alpha * (k - 1.0)
    gamma = xi2 * n_srv.to(torch.float64)
    if hetero:
        inf = float("inf")
        speed = torch.where(pos, speed_floor, inf).amin(dim=1)
        bw_sh = torch.where(pos, uplink_sh, inf).amin(dim=1)
        bw_iso = torch.where(pos, uplink_iso, inf).amin(dim=1)
        bw_multi = torch.minimum(bw_iso, bw_sh / f)
        reduce_t = torch.full_like(f, share) / speed
    else:
        bw_multi = torch.full_like(f, b_inter) / f
        reduce_t = torch.full_like(f, reduce_const)
    bandwidth = torch.where(n_srv > 1, bw_multi, b_intra)
    tau = torch.full_like(f, two_share) / bandwidth + reduce_t + gamma \
        + compute
    phi = torch.clamp(torch.floor(torch.ones_like(tau) / tau), min=1.0)
    return tau, torch.ceil(torch.full_like(tau, iters) / phi)


def _check_score(Y, p, speed_floor, uplink_sh, uplink_iso):
    """Shapes of the score kernel's operands; returns (C, S)."""
    if Y.dim() != 2:
        raise ValueError(f"Y must be [C, S], got {tuple(Y.shape)}")
    C, S = Y.shape
    dev = Y.device
    _build.check(Y, "Y", torch.int64, (C, S), dev)
    _build.check(p, "p", torch.float64, (C,), dev)
    for name, t in (("speed_floor", speed_floor), ("uplink_sh", uplink_sh),
                    ("uplink_iso", uplink_iso)):
        _build.check(t, name, torch.float64, (S,), dev)
    return C, S


def score_rows(Y, p, speed_floor, uplink_sh, uplink_iso, scalars, *,
               hetero: bool, xi1: float, xi2: float, alpha: float,
               b_inter: float, b_intra: float):
    """K4 wrapper: ``(tau, rho)`` [C] float64 of probed candidates.

    ``Y`` [C, S] int64 occupancy rows; ``p`` [C] float64 contention
    levels; the three [S] float64 device-term rows of
    :func:`repro_torch.kernels.tau.cluster_tensors`; ``scalars`` the five
    job scalars (2*share, share, share/gpu_speed, compute, iters), passed
    to the kernel as arguments with the cluster's xi1, xi2, alpha and
    bandwidths."""
    C, S = _check_score(Y, p, speed_floor, uplink_sh, uplink_iso)
    kw = dict(hetero=bool(hetero), xi1=float(xi1), xi2=float(xi2),
              alpha=float(alpha), b_inter=float(b_inter),
              b_intra=float(b_intra))
    if Y.device.type == "cpu":
        return score_rows_plain(Y, p, speed_floor, uplink_sh, uplink_iso,
                                tuple(float(x) for x in scalars), **kw)
    out = torch.empty(2 * C, dtype=torch.float64, device=Y.device)
    if C:
        _build.launch("placement", _SIGNATURES, "score_rows", Y.device,
                      *(t.data_ptr() for t in (Y, p, speed_floor, uplink_sh,
                                               uplink_iso)),
                      C, S, *_score_scalars(scalars, **kw), out.data_ptr())
        LAUNCHES["score"] += 1
    return out[:C], out[C:]


def _score_scalars(scalars, *, hetero, xi1, xi2, alpha, b_inter, b_intra):
    """The score kernel's scalar arguments after (C, S), in its order."""
    return (int(hetero), xi1, xi2, alpha, b_inter, b_intra,
            *(float(x) for x in scalars))


# --------------------------------------------------------------------------
# NumPy-in / NumPy-out entry points of the columnar engine
# --------------------------------------------------------------------------


class _Staging:
    """Per-(cluster, device) state of the two entry points: the cluster's
    GPU -> server map on the device, and for each entry point a pinned
    host buffer and a device buffer of int64 words in each direction,
    grown (doubled) as needed.  A call reuses them only after the wait
    that ended the previous call, and copies its results out of them."""

    def __init__(self, cluster, device: torch.device):
        self.device = device
        self.gpu_server = torch.tensor(np.asarray(cluster.gpu_server),
                                       dtype=torch.int64, device=device)
        self._bufs: dict[str, tuple] = {}

    def buffers(self, name: str, words: int):
        """``(host tensor, its int64 NumPy view, device tensor)`` of at
        least ``words`` words."""
        have = self._bufs.get(name)
        if have is None or have[0].numel() < words:
            n = max(words, 2 * have[0].numel() if have else 0, 1)
            host = torch.empty(n, dtype=torch.int64, pin_memory=True)
            have = (host, host.numpy(),
                    torch.empty(n, dtype=torch.int64, device=self.device))
            self._bufs[name] = have
        return have


@functools.lru_cache(maxsize=16)
def _staging(cluster, device: torch.device) -> _Staging:
    return _Staging(cluster, device)


def _job_scalars(cluster, job) -> tuple[float, ...]:
    """(2*share, share, share/gpu_speed, compute, iters) of ``job``."""
    w = float(job.num_gpus)
    share = (job.grad_size / w) * (w - 1.0) if w > 1 else 0.0
    compute = job.dt_fwd * float(job.batch) + job.dt_bwd
    return (2.0 * share, share, share / cluster.gpu_speed, compute,
            float(job.iters))


def pick_orders(cluster, U_stack: np.ndarray, th_lo: np.ndarray,
                th_hi: np.ndarray, rho_u: np.ndarray, pid: np.ndarray,
                job, *, device="cuda"):
    """Pool statistics and stable pick rankings of one step's work.

    ``U_stack`` [nw, N] gathers each work item's busy-time row; ``th_lo``/
    ``th_hi`` its extreme branch thetas, ``rho_u`` its escalated rho/u
    charge and ``pid`` its picker id (0 = FA-FFP, 1 = LBSGF).  Returns
    NumPy ``(V, c_lo, c_hi, order, ok)``: the charged clocks (``U_stack +
    rho_u``, the add the kernel makes, rebuilt here), pool counts at both
    extremes, each row's full stable GPU ordering (the pick is
    ``order[i, :G_j]``) and the pool-large-enough flag -- all
    bit-identical to the NumPy ``pick_many`` forms.  On the card: one
    copy up, one launch of K3, one copy back, one wait."""
    on = obs.on
    if on:
        top = obs.open_span("kernel.pick_orders")
    dev = resolve_device(device)
    nw, N = U_stack.shape
    if on:
        obs.COUNTERS["pool.rows"] += nw
    G = job.num_gpus
    lam_G = float(job.lam * G)
    ct = cluster_tensors(cluster, dev)
    S = ct["caps"].shape[0]
    V = U_stack + rho_u[:, None]
    st = _staging(cluster, dev)
    if dev.type == "cpu":
        outs = pool_stats(
            to_device(U_stack, torch.float64, dev),
            to_device(th_lo, torch.float64, dev),
            to_device(th_hi, torch.float64, dev),
            to_device(rho_u, torch.float64, dev),
            to_device(pid, torch.int64, dev), G, lam_G, ct["offsets"],
            ct["caps"], st.gpu_server)
        c_lo, c_hi, order, ok = (outs[i].numpy() for i in (0, 1, 6, 7))
        if on:
            obs.close_span(top)
        return V, c_lo, c_hi, order, ok
    _check_widths(N, S)
    if on:
        sub = obs.open_span("pick_orders.pack")
    n_in = nw * N + 4 * nw
    host_in, hin, dev_in = st.buffers("pool_in", n_in)
    hf = hin.view(np.float64)
    hf[:nw * N].reshape(nw, N)[...] = U_stack
    hf[nw * N:nw * N + nw] = th_lo
    hf[nw * N + nw:nw * N + 2 * nw] = th_hi
    hf[nw * N + 2 * nw:nw * N + 3 * nw] = rho_u
    hin[nw * N + 3 * nw:n_in] = pid
    n_out = 3 * nw + nw * N                     # c_lo, c_hi, ok, order
    host_out, hout, dev_out = st.buffers("pool_out",
                                         pool_words(nw, N, S))
    if on:
        obs.close_span(sub)
    if nw:
        if on:
            sub = obs.open_span("pick_orders.launch")
        _build.launch("placement", _SIGNATURES, "pool_step", dev,
                      host_in.data_ptr(), dev_in.data_ptr(), G, lam_G,
                      ct["offsets"].data_ptr(), ct["caps"].data_ptr(),
                      st.gpu_server.data_ptr(), nw, N, S, dev_out.data_ptr(),
                      host_out.data_ptr(), n_out)
        if on:
            obs.close_span(sub)
        LAUNCHES["pool"] += 1
    res = hout[:n_out].copy()
    if on:
        obs.close_span(top)
    return (V, res[:nw], res[nw:2 * nw], res[3 * nw:].reshape(nw, N),
            res[2 * nw:3 * nw].view(np.bool_)[:nw])


@obs.spanned("kernel.score_probes")
def score_probes(cluster, job, Y: np.ndarray, p: np.ndarray, *,
                 device="cuda"):
    """Eq. (6)-(8) scoring of one step's probed candidates on ``device``.

    ``Y`` [C, S] holds each candidate's occupancy row and ``p`` its
    host-probed contention level (float64, from the incremental engine's
    suffix counts).  Returns NumPy ``(tau, rho)`` bit-identical to
    ``scalar_tau_many`` + ``slots_for_many``; heterogeneous clusters
    price worst-member device terms exactly like
    :func:`repro_torch.core.contention._hetero_mins`.  On the card: one
    copy up, one launch of K4, one copy back, one wait."""
    dev = resolve_device(device)
    C, S = Y.shape
    ct = cluster_tensors(cluster, dev)
    terms = (ct["speed_floor"], ct["uplink_sh"], ct["uplink_iso"])
    scalars = _job_scalars(cluster, job)
    kw = dict(hetero=cluster.is_heterogeneous, xi1=float(cluster.xi1),
              xi2=float(cluster.xi2), alpha=float(cluster.alpha),
              b_inter=float(cluster.b_inter), b_intra=float(cluster.b_intra))
    if dev.type == "cpu":
        tau, rho = score_rows(to_device(Y, torch.int64, dev),
                              to_device(p, torch.float64, dev), *terms,
                              scalars, **kw)
        return tau.numpy(), rho.numpy()
    st = _staging(cluster, dev)
    n_in = C * S + C
    host_in, hin, dev_in = st.buffers("score_in", n_in)
    hin[:C * S].reshape(C, S)[...] = Y
    hin.view(np.float64)[C * S:n_in] = p
    host_out, hout, dev_out = st.buffers("score_out", 2 * C)
    if C:
        _build.launch("placement", _SIGNATURES, "score_step", dev,
                      host_in.data_ptr(), dev_in.data_ptr(),
                      *(t.data_ptr() for t in terms), C, S,
                      *_score_scalars(scalars, **kw), dev_out.data_ptr(),
                      host_out.data_ptr())
        LAUNCHES["score"] += 1
    res = hout.view(np.float64)[:2 * C].copy()
    return res[:C], res[C:]
