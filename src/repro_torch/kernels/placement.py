"""Columnar placement step: CUDA pool/score kernels and plain versions.

The port of ``repro/kernels/placement.py`` (TPU kernels ``_pool_kernel``
and ``_score_kernel``).  The columnar engine
(:class:`repro_torch.core.columnar.ColumnarPlacement`) advances every
(theta, kappa) branch of the SJF-BCO forest by one job per step; per step
it needs the Eq. (16) feasibility pools (``U + rho/u <= theta + 1e-9``),
the per-server busy/feasible-count reductions behind the FA-FFP/LBSGF
picks, and the Eq. (6)-(8) tau/rho scoring of the probed candidates.

  * :func:`pool_stats` (kernel ``"pool"``) -- V, the pool counts at each
    work row's two extreme thetas, GPU-id-order per-server busy sums,
    feasible-slot counts and the FA-FFP best server, one block per row;
    :func:`pick_orders` ranks the picks on the host from its outputs with
    NumPy's stable sorts over those bitwise-equal keys;
  * :func:`score_rows` (kernel ``"score"``) -- Eq. (8) tau and the rho-hat
    slot count per probed candidate; :func:`score_probes` computes the
    degradation f and gamma on the host first (every multiply that feeds
    an addition stays there, as in the reference).

A CPU tensor runs the plain PyTorch version beside each wrapper
(:func:`pool_stats_plain`, :func:`score_rows_plain`).  Everything is
float64; the per-server sums replay ``np.bincount``'s sequential GPU-id
order (no ``torch.sum`` over floats), so both backends are bit-identical
to the NumPy pickers.  Shapes are taken at run time, so nothing is padded.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.tau import cluster_tensors, to_device

__all__ = ["pick_orders", "score_probes", "pool_stats", "pool_stats_plain",
           "score_rows", "score_rows_plain"]

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    "pool_stats": [_P] * 4 + [_L] + [_P] * 9 + [_I] * 3 + [_P],
    "score_rows": [_P] * 9 + [_I] * 3 + [_D] * 2 + [_P],
}


def pool_stats_plain(U, th_lo, th_hi, rho_u, G, offsets, caps):
    """Plain PyTorch version of the pool kernel (K3).

    Returns ``(V, c_lo, c_hi, load, cnt, best_srv, has_fit)``.  The busy
    sums add each server's clocks one GPU column at a time in GPU-id order
    (trailing lanes of smaller servers add +0.0, the identity for the
    non-negative clocks), exactly ``np.bincount``'s sequence."""
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
    return V, c_lo, c_hi, load, cnt, best_srv, has_fit


def pool_stats(U, th_lo, th_hi, rho_u, G: int, offsets, caps):
    """K3 wrapper over one step's work rows.

    ``U`` [B, N] float64 busy-time clocks; ``th_lo``/``th_hi``/``rho_u``
    [B] float64 (each row's extreme thetas and escalated rho/u charge);
    ``G`` the job's GPU count; ``offsets``/``caps`` [S] int64 (each
    server's first GPU id and capacity).  Returns ``(V [B, N] f64, c_lo
    [B] i64, c_hi [B] i64, load [B, S] f64, cnt [B, S] i64, best_srv [B]
    i64, has_fit [B] bool)``."""
    if U.dim() != 2:
        raise ValueError(f"U must be [B, N], got {tuple(U.shape)}")
    B, N = U.shape
    dev = U.device
    _build.check(U, "U", torch.float64, (B, N), dev)
    for name, t in (("th_lo", th_lo), ("th_hi", th_hi), ("rho_u", rho_u)):
        _build.check(t, name, torch.float64, (B,), dev)
    S = caps.shape[0]
    _build.check(offsets, "offsets", torch.int64, (S,), dev)
    _build.check(caps, "caps", torch.int64, (S,), dev)
    G = int(G)
    if dev.type == "cpu":
        return pool_stats_plain(U, th_lo, th_hi, rho_u, G, offsets, caps)
    V = torch.empty((B, N), dtype=torch.float64, device=dev)
    c_lo = torch.empty(B, dtype=torch.int64, device=dev)
    c_hi = torch.empty(B, dtype=torch.int64, device=dev)
    load = torch.empty((B, S), dtype=torch.float64, device=dev)
    cnt = torch.empty((B, S), dtype=torch.int64, device=dev)
    best_srv = torch.empty(B, dtype=torch.int64, device=dev)
    has_fit = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        _build.launch("placement", _SIGNATURES, "pool_stats", dev,
                      U.data_ptr(), th_lo.data_ptr(), th_hi.data_ptr(),
                      rho_u.data_ptr(), G, offsets.data_ptr(),
                      caps.data_ptr(), V.data_ptr(), c_lo.data_ptr(),
                      c_hi.data_ptr(), load.data_ptr(), cnt.data_ptr(),
                      best_srv.data_ptr(), has_fit.data_ptr(), B, N, S)
        LAUNCHES["pool"] += 1
    return V, c_lo, c_hi, load, cnt, best_srv, has_fit


def score_rows_plain(Y, f, gamma, scalars, speed_floor, uplink_sh,
                     uplink_iso, *, hetero, b_inter, b_intra):
    """Plain PyTorch version of the score kernel (K4): the expressions of
    ``contention.scalar_tau_many`` + ``slots_for_many`` in their order.
    Every division is tensor by tensor (see ``tau._full``)."""
    B = Y.shape[0]
    two_share, share, reduce_const, compute, iters = (
        scalars[i].expand(B) for i in range(5))
    pos = Y > 0
    multi = pos.sum(dim=1) > 1
    if hetero:
        inf = float("inf")
        speed = torch.where(pos, speed_floor, inf).amin(dim=1)
        bw_sh = torch.where(pos, uplink_sh, inf).amin(dim=1)
        bw_iso = torch.where(pos, uplink_iso, inf).amin(dim=1)
        bw_multi = torch.minimum(bw_iso, bw_sh / f)
        reduce_t = share / speed
    else:
        bw_multi = torch.full_like(f, b_inter) / f
        reduce_t = reduce_const
    bandwidth = torch.where(multi, bw_multi, b_intra)
    tau = two_share / bandwidth + reduce_t + gamma + compute
    phi = torch.clamp(torch.floor(torch.ones_like(tau) / tau), min=1.0)
    return tau, torch.ceil(iters / phi)


def score_rows(Y, f, gamma, scalars, speed_floor, uplink_sh, uplink_iso, *,
               hetero: bool, b_inter: float, b_intra: float):
    """K4 wrapper: ``(tau, rho)`` [B] float64 of probed candidates.

    ``Y`` [B, S] int64 occupancy rows; ``f``/``gamma`` [B] float64 (the
    host-computed degradation and xi2 * n_srv); ``scalars`` [5] float64
    (2*share, share, share/gpu_speed, compute, iters); the three [S]
    float64 device-term rows of :func:`repro_torch.kernels.tau.
    cluster_tensors`."""
    if Y.dim() != 2:
        raise ValueError(f"Y must be [B, S], got {tuple(Y.shape)}")
    B, S = Y.shape
    dev = Y.device
    _build.check(Y, "Y", torch.int64, (B, S), dev)
    _build.check(f, "f", torch.float64, (B,), dev)
    _build.check(gamma, "gamma", torch.float64, (B,), dev)
    _build.check(scalars, "scalars", torch.float64, (5,), dev)
    for name, t in (("speed_floor", speed_floor), ("uplink_sh", uplink_sh),
                    ("uplink_iso", uplink_iso)):
        _build.check(t, name, torch.float64, (S,), dev)
    if dev.type == "cpu":
        return score_rows_plain(Y, f, gamma, scalars, speed_floor, uplink_sh,
                                uplink_iso, hetero=hetero, b_inter=b_inter,
                                b_intra=b_intra)
    tau = torch.empty(B, dtype=torch.float64, device=dev)
    rho = torch.empty(B, dtype=torch.float64, device=dev)
    if B:
        _build.launch("placement", _SIGNATURES, "score_rows", dev,
                      Y.data_ptr(), f.data_ptr(), gamma.data_ptr(),
                      scalars.data_ptr(), speed_floor.data_ptr(),
                      uplink_sh.data_ptr(), uplink_iso.data_ptr(),
                      tau.data_ptr(), rho.data_ptr(), B, S, int(hetero),
                      b_inter, b_intra)
        LAUNCHES["score"] += 1
    return tau, rho


# --------------------------------------------------------------------------
# NumPy-in / NumPy-out entry points of the columnar engine
# --------------------------------------------------------------------------


def pick_orders(cluster, U_stack: np.ndarray, th_lo: np.ndarray,
                th_hi: np.ndarray, rho_u: np.ndarray, pid: np.ndarray,
                job, *, device="cuda"):
    """Pool statistics on ``device`` + host rankings over one step's work.

    ``U_stack`` [nw, N] gathers each work item's busy-time row; ``th_lo``/
    ``th_hi`` its extreme branch thetas, ``rho_u`` its escalated rho/u
    charge and ``pid`` its picker id (0 = FA-FFP, 1 = LBSGF).  Returns
    NumPy ``(V, c_lo, c_hi, order, ok)``: the charged clocks, pool counts
    at both extremes, each row's full stable GPU ordering (the pick is
    ``order[i, :G_j]``) and the pool-large-enough flag -- all
    bit-identical to the NumPy ``pick_many`` forms.  The stable rankings
    run here with NumPy's sorts, mirroring the second halves of
    ``_fa_ffp_many`` / ``_lbsgf_many`` term for term."""
    dev = resolve_device(device)
    nw, N = U_stack.shape
    G = job.num_gpus
    gpu_server = np.asarray(cluster.gpu_server)
    caps = cluster.capacities_array
    S = caps.shape[0]
    ct = cluster_tensors(cluster, dev)
    outs = pool_stats(
        to_device(U_stack, torch.float64, dev),
        to_device(th_lo, torch.float64, dev),
        to_device(th_hi, torch.float64, dev),
        to_device(rho_u, torch.float64, dev), G, ct["offsets"], ct["caps"])
    # Everything but the per-server counts comes back to the host.
    V, c_lo, c_hi, load, best_srv, has_fit = (
        outs[i].cpu().numpy() for i in (0, 1, 2, 3, 5, 6))
    feas = V <= th_lo[:, None] + 1e-9                  # Eq. (16) pool
    U = U_stack
    order = np.empty((nw, N), dtype=np.int64)
    ok = np.empty(nw, dtype=bool)
    fa = np.flatnonzero(pid == 0)
    if fa.size:
        # FA-FFP: pack into the best-fit server when one fits, else
        # spread over the whole pool (== _fa_ffp_many's masked keys).
        in_best = feas[fa] & (gpu_server[None, :] == best_srv[fa, None])
        keys = np.where(has_fit[fa, None],
                        np.where(in_best, U[fa], np.inf),
                        np.where(feas[fa], U[fa], np.inf))
        order[fa] = np.argsort(keys, axis=1, kind="stable")
        ok[fa] = c_lo[fa] >= G
    lb = np.flatnonzero(pid == 1)
    if lb.size:
        # LBSGF: least-busy server prefix of lambda_j*G capacity, then
        # server-rank-major / least-U lexsort (== _lbsgf_many).
        nl = lb.size
        srv_order = np.argsort(load[lb] / caps[None, :].astype(np.float64),
                               axis=1, kind="stable")
        cum = np.cumsum(np.take_along_axis(
            np.broadcast_to(caps[None, :], srv_order.shape), srv_order,
            axis=1), axis=1)
        m = np.minimum((cum < job.lam * G).sum(axis=1) + 1, S)
        pos = np.arange(S)[None, :]
        rank_vals = np.where(pos < m[:, None], pos, -1)
        srv_rank = np.empty_like(srv_order)
        np.put_along_axis(srv_rank, srv_order, rank_vals, axis=1)
        ranks = srv_rank[:, gpu_server]
        pool = feas[lb] & (ranks >= 0)
        ok[lb] = pool.sum(axis=1) >= G
        k_rank = np.where(pool, ranks, S + 1)
        k_U = np.where(pool, U[lb], np.inf)
        r_off = (np.arange(nl) * N)[:, None]
        flat = np.lexsort((k_U.ravel(), k_rank.ravel(),
                           np.repeat(np.arange(nl), N)))
        order[lb] = flat.reshape(nl, N) - r_off
    return V, c_lo, c_hi, order, ok


def score_probes(cluster, job, Y: np.ndarray, p: np.ndarray, *,
                 device="cuda"):
    """Eq. (6)-(8) scoring of one step's probed candidates on ``device``.

    ``Y`` [C, S] holds each candidate's occupancy row and ``p`` its
    host-probed contention level (float64, from the incremental engine's
    suffix counts).  Returns NumPy ``(tau, rho)`` bit-identical to
    ``scalar_tau_many`` + ``slots_for_many``; heterogeneous clusters
    price worst-member device terms exactly like
    :func:`repro_torch.core.contention._hetero_mins`."""
    from repro_torch.core.contention import degradation
    dev = resolve_device(device)
    # Host-side contention terms: every multiply that would feed an
    # addition on the device.
    k = np.maximum(cluster.xi1 * np.asarray(p, dtype=np.float64), 1.0)
    f = degradation(cluster.alpha, k)
    gamma = cluster.xi2 * (Y > 0).sum(axis=1).astype(np.float64)
    w = float(job.num_gpus)
    share = (job.grad_size / w) * (w - 1.0) if w > 1 else 0.0
    compute = job.dt_fwd * float(job.batch) + job.dt_bwd
    scalars = np.array([2.0 * share, share, share / cluster.gpu_speed,
                        compute, float(job.iters)])
    ct = cluster_tensors(cluster, dev)
    tau, rho = score_rows(
        to_device(Y, torch.int64, dev), to_device(f, torch.float64, dev),
        to_device(gamma, torch.float64, dev),
        to_device(scalars, torch.float64, dev), ct["speed_floor"],
        ct["uplink_sh"], ct["uplink_iso"], hetero=cluster.is_heterogeneous,
        b_inter=float(cluster.b_inter), b_intra=float(cluster.b_intra))
    return tau.cpu().numpy(), rho.cpu().numpy()
